"""The pooled live-session fold: the slots that posted add their new
subfingerprints' terms into their running diagonal sums ``d_a [batch, L,
S]`` and ``d_b [batch, L, n_cap]`` (float32, in place), the device work of
``streaming.incremental.IncrementalLibraryMatcher.update_slots``.

For posting slot ``g`` at base age ``b`` with ``k`` new rows (arrival ``i
= b + t``, in ascending ``t``), entry ``e`` of ``n`` valid rows::

    h(e, r, t)    = popc(Pl[e, r] & Pq[t]) + popc(Nl[e, r] & Nq[t])
    d_a[g, e, d] += h(e, d + i, t) * inv_lib[e, d + i]      d + i < n
    d_b[g, e, d] += h(e, i - d, t) * inv_q[t]               0 <= i - d < n

over the first ``mask_pairs`` pairs, each product and sum rounded once in
float32; ``inv_q[t]`` is 1 over the query row's set bits (0 for none).
Rows past an entry's count hold no bit.  Hit counts are exact integers and
the terms of one element arrive in the same order either way, so the
kernel's state equals the plain version's bit for bit.

Replaces no TPU kernel: the JAX package's pool folds with plain ``jnp``
(hits of every slot, then per-arrival updates), and the port did the same
with a GEMM over every slot.  On a CUDA tensor ``csrc/slot_fold.cu`` runs
(one launch, the posting slots only, hits from the packed words); on a CPU
tensor the plain version below, the per-arrival fold of the port's pool.
"""

from __future__ import annotations

import numpy as np
import torch

from lbaudiodetective_torch.ops.kernels.match_packed import popcount32, prefix_mask_words

#: Words a row the kernel takes (256 pairs).
MAX_WORDS = 8


def inv_possible(w: torch.Tensor) -> torch.Tensor:
    """1 / ``w`` where ``w`` > 0, else 0 (float32 possible-hit counts)."""
    return torch.where(w > 0.0, 1.0 / torch.clamp(w, min=1.0), torch.zeros_like(w))


def fold_arrival(d_a: torch.Tensor, d_b: torch.Tensor, h_t: torch.Tensor,
                 inv_lib: torch.Tensor, lib_row_valid: torch.Tensor,
                 inv_q_t: torch.Tensor, slots, i: int) -> None:
    """Add arrival ``i``'s terms of the streams ``slots`` (a slice or an
    index tensor) into their accumulators, in place.  ``h_t`` ``[G', L, S]``
    holds their hit counts, ``inv_q_t`` ``[G']`` their query reciprocal."""
    s = d_a.shape[-1]
    if i < s:
        # Orientation A: column i adds sim_a[e, d + i] to diagonal d.
        col = h_t[..., i:] * inv_lib[:, i:]
        d_a[slots, :, :s - i] += col
    # Orientation B: library row j adds to diagonal d = i - j (j <= i,
    # d < n_cap: the caller has grown the state to hold age i + 1).
    lo = max(0, i - s + 1)
    row = h_t[..., :i - lo + 1] * inv_q_t[:, None, None]
    row = row * lib_row_valid[:, :i - lo + 1]
    d_b[slots, :, lo:i + 1] += row.flip(-1)


def slot_fold_plain(d_a: torch.Tensor, d_b: torch.Tensor, lib_pos_w: torch.Tensor,
                    lib_neg_w: torch.Tensor, n_lib: torch.Tensor, inv_lib: torch.Tensor,
                    mask_pairs: int, q_pos_w: torch.Tensor, q_neg_w: torch.Tensor,
                    slots: torch.Tensor, base: torch.Tensor, k_valid: torch.Tensor) -> None:
    """Plain version: for each arrival index ``t``, the hit counts of the
    slots still posting (AND and popcount of the words, rows past a count
    zero), then one :func:`fold_arrival` for each distinct age among them."""
    dev = d_a.device
    l, s, w = lib_pos_w.shape
    m = torch.from_numpy(prefix_mask_words(mask_pairs, w).view(np.int32)).to(dev)
    qp, qn = q_pos_w & m, q_neg_w & m                                # [G', k, W]
    inv_q = inv_possible((popcount32(qp) + popcount32(qn)).sum(-1).to(torch.float32))
    valid = torch.arange(s, device=dev)[None, :] < n_lib[:, None].long()   # [L, S]
    row_valid = valid.to(torch.float32)
    slots, base, k_valid = (x.cpu().numpy().astype(np.int64) for x in (slots, base, k_valid))
    for t in range(min(int(k_valid.max(initial=0)), qp.shape[1])):
        live = np.flatnonzero(k_valid > t)
        sel = torch.from_numpy(live).to(dev)
        h = torch.zeros((live.size, l, s), dtype=torch.int32, device=dev)
        for k in range(w):
            h += popcount32(lib_pos_w[None, :, :, k] & qp[sel, t, k][:, None, None])
            h += popcount32(lib_neg_w[None, :, :, k] & qn[sel, t, k][:, None, None])
        h = torch.where(valid, h, 0).to(torch.float32)
        for i in np.unique(base[live] + t):
            pick = np.flatnonzero(base[live] + t == i)
            rows = torch.from_numpy(slots[live[pick]]).to(dev)
            at = torch.from_numpy(pick).to(dev)
            fold_arrival(d_a, d_b, h[at], inv_lib, row_valid, inv_q[sel[at], t], rows, int(i))


def _check(d_a, d_b, lib_pos_w, lib_neg_w, n_lib, inv_lib, q_pos_w, q_neg_w, slots, base,
           k_valid) -> None:
    ints = (lib_pos_w, lib_neg_w, n_lib, q_pos_w, q_neg_w, slots, base, k_valid)
    if any(t.dtype != torch.int32 for t in ints) or any(
            t.dtype != torch.float32 for t in (d_a, d_b, inv_lib)):
        raise TypeError("slot_fold takes float32 state and inv_lib, int32 words, counts "
                        "and slot tables")
    if d_a.dim() != 3 or lib_pos_w.dim() != 3 or q_pos_w.dim() != 3:
        raise ValueError("slot_fold takes [batch, L, S] state, [L, S, W] library words "
                         "and [G, k, W] query words")
    batch, l, s = d_a.shape
    g, _, w = q_pos_w.shape
    if (lib_pos_w.shape != (l, s, w) or lib_neg_w.shape != lib_pos_w.shape
            or q_neg_w.shape != q_pos_w.shape or d_b.shape[:2] != (batch, l)
            or d_b.dim() != 3 or n_lib.shape != (l,) or inv_lib.shape != (l, s)
            or any(t.shape != (g,) for t in (slots, base, k_valid))):
        raise ValueError("slot_fold shapes disagree")
    if len({t.device for t in (d_a, d_b, inv_lib, *ints)}) != 1:
        raise ValueError("state, library and slot tables must share one device")


def slot_fold(d_a: torch.Tensor, d_b: torch.Tensor, lib_pos_w: torch.Tensor,
              lib_neg_w: torch.Tensor, n_lib: torch.Tensor, inv_lib: torch.Tensor,
              mask_pairs: int, q_pos_w: torch.Tensor, q_neg_w: torch.Tensor,
              slots: torch.Tensor, base: torch.Tensor, k_valid: torch.Tensor) -> None:
    """Fold ``k_valid[g]`` new rows (``q_pos_w``/``q_neg_w`` ``[G, k_max,
    W]`` int32 words) of state row ``slots[g]``, at base age ``base[g]``,
    into ``d_a``/``d_b`` in place, against library words ``[L, S, W]``,
    counts ``[L]`` and ``inv_lib`` ``[L, S]`` (0 past each count).  The
    caller has grown ``d_b`` to hold every new age.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    once (``slot_fold.launches`` counts the launches), at any ``S``: the
    kernel streams each entry's rows through a buffer of fixed size."""
    _check(d_a, d_b, lib_pos_w, lib_neg_w, n_lib, inv_lib, q_pos_w, q_neg_w, slots, base,
           k_valid)
    dev = d_a.device
    if dev.type == "cpu":
        slot_fold_plain(d_a, d_b, lib_pos_w, lib_neg_w, n_lib, inv_lib, mask_pairs, q_pos_w,
                        q_neg_w, slots, base, k_valid)
        return
    if dev.type != "cuda":
        raise NotImplementedError(f"no fold kernel for device {dev}")
    if not (d_a.is_contiguous() and d_b.is_contiguous()):
        raise ValueError("slot_fold updates contiguous state in place")
    g, k_max, w = q_pos_w.shape
    if w > MAX_WORDS:
        raise ValueError(f"slot_fold takes at most {MAX_WORDS} words a row, got {w}")
    batch, l, s = d_a.shape
    if g == 0 or k_max == 0 or l == 0:
        return
    from lbaudiodetective_torch.ops.kernels._build import check, load_library

    lib = load_library()
    t = [x.contiguous() for x in (lib_pos_w, lib_neg_w, n_lib, inv_lib, slots, base, k_valid,
                                  q_pos_w, q_neg_w)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        check(lib.lbad_slot_fold(d_a.data_ptr(), d_b.data_ptr(), batch, l, s, d_b.shape[-1],
                                 t[0].data_ptr(), t[1].data_ptr(), t[2].data_ptr(),
                                 t[3].data_ptr(), mask_pairs, g, k_max, t[4].data_ptr(),
                                 t[5].data_ptr(), t[6].data_ptr(), t[7].data_ptr(),
                                 t[8].data_ptr(), w, stream), "slot_fold")
    slot_fold.launches += 1


slot_fold.launches = 0
