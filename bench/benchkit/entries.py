"""The program's entry points that a traced run times, as the per-layer
metrics' readers declare them.

A reader that reads the calls of an entry point exports
``ENTRY = (module, function name, describe)``: the program's module by its
import name, the function the models look up there at call time, and
``describe(*args, **kwargs) -> dict``, the problem shape of a call that the
reader's counts take.  The traced run wraps each function that the cell's
readers declare (their union by function name) in a range
``bench::<function name>`` (``profile.Calls``).  Readers of one entry point
share its tuple from here, so that their union is one range.
"""
from __future__ import annotations

OPS = "repro_torch.kernels.ops"


def describe_attention(q, k, v, *args, causal=True, window=None,
                       return_lse=False, **kwargs) -> dict:
    B, Hq, Sq, dh = q.shape
    return {"B": B, "Hq": Hq, "Hkv": k.shape[1], "Sq": Sq,
            "Skv": k.shape[2], "dh": dh, "causal": causal, "window": window,
            "lse": bool(return_lse), "itemsize": q.element_size()}


def describe_ssd(x, dt, A, B, C, *args, **kwargs) -> dict:
    Bz, H, L, P = x.shape
    return {"B": Bz, "H": H, "L": L, "P": P, "G": B.shape[1],
            "N": B.shape[3], "x_size": x.element_size(),
            "dt_size": dt.element_size(), "a_size": A.element_size(),
            "bc_size": B.element_size(), "y_size": x.element_size()}


FLASH_ATTENTION = (OPS, "flash_attention", describe_attention)
SSD_SCAN = (OPS, "ssd_scan", describe_ssd)


def union(readers) -> list:
    """The ``ENTRY`` of each reader that has one, once by function name, in
    the readers' order; two readers that declare one name differently are
    an error of the benchmark."""
    out: dict = {}
    for r in readers:
        entry = getattr(r, "ENTRY", None)
        if entry is None:
            continue
        have = out.setdefault(entry[1], entry)
        if have[0] != entry[0] or have[2] is not entry[2]:
            raise ValueError(f"two readers declare the entry point "
                             f"{entry[1]!r} differently: {have} and {entry}")
    return list(out.values())
