"""The yardstick: published H100 peaks and the operation counts of the
kernels and of a training step, all worked out from shapes.

Frozen here so that a change to the program cannot move the measure it is
judged by. The kernel counts are those of the kernel table in ``PERF.md``
(the larger of operations over the f32 peak and bytes over the HBM rate,
each input read and each output written once).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_F32_FLOPS = 67e12  # IEEE float32 on the CUDA cores (the port leaves TF32 off)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# Operations per Gram pair beside the distance product (d2 assembly, one
# exp, the integer-power ladder and its sums).
OPS_PER_ENTRY = 20


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """``(ms, 'operations' | 'bytes')``: the least time of a call on one card."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sym_pairs(m: int) -> int:
    """Off-diagonal entries of a symmetric m x m Gram, each counted once."""
    return m * (m - 1) // 2


def gram_ops(m: int, d: int, backward: bool = False) -> float:
    """The distance product and the bandwidth ladder over each unordered
    pair once, plus for the backward the product S @ z (2 m^2 d)."""
    pairs = sym_pairs(m)
    return 2 * pairs * d + OPS_PER_ENTRY * pairs + (2 * m * m * d if backward else 0)


def gram_bytes(m: int, d: int, backward: bool = False, stash: bool = False) -> float:
    """K1 / K2 read z and its norms and write the sums (K2 also K'); K3
    reads z and writes S @ z and the row sums."""
    if backward:
        return 4 * (2 * m * d + 2 * m + 1)
    return 4 * (m * d + m + 1 + 4 + (m * m if stash else 0))


def gram_bound_ms(m: int, d: int, backward: bool = False, stash: bool = False) -> float:
    return bound_ms(gram_ops(m, d, backward), gram_bytes(m, d, backward, stash))[0]


def knn_ops(n_selected: int, nm: int, nt: int, ntr: int) -> float:
    """Over each mask's selected columns (``n_selected`` in all): the cross
    products (2 per pair and column) and the masked norms of the test and
    train rows; one compare per (mask, row, train) entry."""
    return 2 * nt * ntr * n_selected + 2 * (nt + ntr) * n_selected + nm * nt * ntr


def knn_bytes(nm: int, nt: int, ntr: int, d: int) -> float:
    return 4 * (nm * d + nt * d + ntr * d + nm * nt)


def knn_bound_ms(n_selected: int, nm: int, nt: int, ntr: int, d: int) -> float:
    return bound_ms(knn_ops(n_selected, nm, nt, ntr), knn_bytes(nm, nt, ntr, d))[0]


def latent_size(d: int) -> int:
    return max(int(d / 16), 1)


def generator_layers(d: int):
    """(fan_in, fan_out) of the generator L -> 2L -> 4L -> 8L -> d."""
    L = latent_size(d)
    widths = [L, 2 * L, 4 * L, 8 * L, d]
    return list(zip(widths[:-1], widths[1:]))


def encoder_layers(d: int):
    L = latent_size(d)
    widths = [d, 8 * L, 4 * L, 2 * L, L]
    return list(zip(widths[:-1], widths[1:]))


def decoder_layers(d: int):
    return [(o, i) for i, o in reversed(encoder_layers(d))]


def _macs(layers) -> int:
    return sum(i * o for i, o in layers)


def stack_flops(layers, rows: int, backward: bool, input_grad: bool) -> float:
    """A linear stack on ``rows`` rows: the forward (2 per multiply-add),
    and with ``backward`` the weight gradients and the input gradients of
    every layer whose input needs one (all but the first unless
    ``input_grad``)."""
    fwd = 2 * rows * _macs(layers)
    if not backward:
        return fwd
    wgrad = 2 * rows * _macs(layers)
    igrad = 2 * rows * _macs(layers if input_grad else layers[1:])
    return fwd + wgrad + igrad


def no_kl_step_flops(batch: int, d: int) -> float:
    """One no-kl step: the generator forward and backward (no gradient for
    the noise) and the MMD at m = 2 batch, forward and backward."""
    return (stack_flops(generator_layers(d), batch, True, False)
            + gram_ops(2 * batch, d, backward=True))


def kl_detector_step_flops(batch: int, d: int) -> float:
    """One detector step: the generator forward (no gradient), the encoder
    and decoder on the batch and its masked copy, forward and backward (the
    encoder's input needs none), and the MMD on m = 2 batch encodings,
    forward and backward."""
    L = latent_size(d)
    gen = stack_flops(generator_layers(d), batch, False, False)
    det = (stack_flops(encoder_layers(d), 2 * batch, True, False)
           + stack_flops(decoder_layers(d), 2 * batch, True, True))
    return gen + det + gram_ops(2 * batch, L, backward=True)


def kl_generator_step_flops(batch: int, d: int) -> float:
    """One generator step of the detached kl generator: the generator and
    the encoder forward, and the MMD forward on m = 2 batch encodings."""
    L = latent_size(d)
    return (stack_flops(generator_layers(d), batch, False, False)
            + stack_flops(encoder_layers(d), 2 * batch, False, False)
            + gram_ops(2 * batch, L))
