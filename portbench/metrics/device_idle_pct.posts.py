"""Share of the traced window in which no kernel, copy or set ran on the
card."""

from portbench.harness import idle_pct as read  # noqa: F401
