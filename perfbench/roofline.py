"""The benchmark's yardstick for kernels: the card's peaks and K2's work.

Peaks are NVIDIA's H100 SXM data sheet's (dense, no sparsity), at the
full 700 W; a card set to a lower power limit runs below them, so every
roofline share is reported beside the card's limit.

K2 is the row scatter ``out[p, :] += rows[e, :]`` for ``seg[e] == p``
(``repro_torch.kernels.ops.segsum_rows``).  Its least time is taken from
the call's logical inputs and output, whatever regime or tiling runs it:
the segment ids and the rows read once, the table written once (and read
once where the call adds into a table it is given), one addition a row
element.  A later rewrite of K2 is read against the same work.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

#: Published peaks by the name ``torch.cuda.get_device_name`` gives.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_ops_per_s": 67e12,
                              "bf16_ops_per_s": 989e12},
}
#: The card the published peaks hold for, used where a card is not named
#: in :data:`PEAKS` (its name is in the result line either way).
DEFAULT_PEAKS = PEAKS["NVIDIA H100 80GB HBM3"]


class Work(NamedTuple):
    bytes: float
    ops: float


def k2_work(n_edges: int, width: int, n_segments: int,
            accumulate: bool = False, id_bytes: int = 4,
            value_bytes: int = 4) -> Work:
    """Bytes and float32 additions of one K2 call: ``n_edges`` ids and
    rows of ``width`` values into ``n_segments`` rows of a table."""
    table = value_bytes * n_segments * width
    return Work(bytes=id_bytes * n_edges + value_bytes * n_edges * width
                + table * (2 if accumulate else 1),
                ops=float(n_edges) * width)


def least_seconds(work: Work, peaks: Mapping[str, float] = DEFAULT_PEAKS,
                  ops_key: str = "fp32_ops_per_s") -> float:
    """The roofline's least time: the larger of bytes over bandwidth and
    operations over the peak rate."""
    return max(work.bytes / peaks["hbm_bytes_per_s"],
               work.ops / peaks[ops_key])
