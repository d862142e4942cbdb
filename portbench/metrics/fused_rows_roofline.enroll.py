"""Share of the least time (``portbench.work.rows_bound_s``) that the rows
kernel (``csrc/fused_rows.cu``) took over the traced enrollment batches:
the subfingerprints each batch's clips need, against the device time of the
kernel's launches."""

from portbench import work


def read(trace):
    g = trace.geom
    bound = sum(work.rows_bound_s(g, 1, n * g.rows_per_frame)
                for call in trace.calls("process_decoded_batch") for n in call["info"]["n_sub"])
    spent = trace.device_ns("fused_rows_kernel") / 1e9
    return 100.0 * bound / spent if spent > 0 and bound > 0 else None
