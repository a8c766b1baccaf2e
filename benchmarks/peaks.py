"""Published peak rates of the devices this repository measures on.

One table, keyed by ``jax.devices()[0].device_kind``.  A roofline share is
a kernel's least possible time (bytes over peak bandwidth, or operations
over peak rate, whichever is larger) divided by its measured time.  A
device missing from the table is an error: no number is divided by a
guessed peak.
"""

from __future__ import annotations

# NVIDIA H100 data sheet, SXM part, at the full 700 W power limit.
_H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_flops_per_s": 989e12,
    "source": "NVIDIA H100 data sheet (SXM): 3.35 TB/s HBM3, "
              "989 TFLOP/s dense bf16",
}

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peak(device_kind: str) -> dict:
    """The peak-rate entry of ``device_kind``; raises KeyError if absent."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device kind {device_kind!r}; add it to "
            f"benchmarks/peaks.py with its source") from None


def bandwidth_share(device_kind: str, nbytes: int, seconds: float) -> float:
    """Memory-bound roofline share: (nbytes / peak bandwidth) / seconds."""
    return nbytes / peak(device_kind)["hbm_bytes_per_s"] / seconds
