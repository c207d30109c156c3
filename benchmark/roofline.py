"""Peaks of one H100 and the least time a piece of work could take.

The arithmetic of ``chip_smoke.py``'s ``bound`` and ``scan_bound``,
kept with the benchmark so that later changes to the program cannot move
the yardstick.  Published peaks of one H100 SXM at its full power limit
(NVIDIA's data sheet, dense): 3.35 TB/s of HBM; 67 TFLOP/s f32 outside
the tensor cores, 989 TFLOP/s bf16, 1,979 TOP/s int8.
"""

from __future__ import annotations

from typing import Tuple

HBM_BPS = 3.35e12
PEAK_OPS = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}


def bound_s(n_bytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """The least seconds the card could take: bytes over the memory rate
    or operations over the peak rate of their type, whichever is larger,
    and which of the two it was."""
    t_bytes = n_bytes / HBM_BPS
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def scan_ops(n_rows: int, b: int, d: int, precision: str) -> float:
    """A scan's matrix products over ``n_rows`` real rows and ``b`` real
    queries of width ``d``: 2 N B D operations (int16: four int8 digit
    products each)."""
    return 2.0 * n_rows * b * d * (4 if precision == "int16" else 1)


def scan_peak_kind(precision: str) -> str:
    return "bf16" if precision == "bf16" else "int8"


def scan_bytes(stream_bytes: float, n_rows: int, b: int, d: int, M: int,
               sub: int = 32) -> float:
    """Bytes a compressed scan moves once: the tile stream it decodes
    (``stream_bytes``, the engine's tile tensors) and the bf16 query
    operand read, and written the f32 minimum of each ``sub``-row
    subtile a query and the decoded codes it hands the rerank (M bytes
    a row)."""
    return (stream_bytes + 2.0 * b * d + 4.0 * b * (-(-n_rows // sub))
            + float(n_rows) * M)
