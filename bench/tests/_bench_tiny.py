"""Small versions of the benchmark's configurations and traffic, for the
CPU tests: every key of the real files, the widths cut to a few dozen."""
from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchkit import manifest  # noqa: E402

B, S = 2, 64


def config(name: str, dtype: str = "bfloat16") -> dict:
    cfg = manifest.config(manifest.manifest(), name)
    cfg.update(n_layers=2, d_model=64, vocab_size=256, param_dtype=dtype,
               compute_dtype=dtype)
    if cfg["n_heads"]:
        cfg.update(n_heads=4, head_dim=16, d_ff=128)
    if cfg.get("ssm"):
        cfg["ssm"] = dict(cfg["ssm"], d_state=16, head_dim=16, chunk=16)
    if cfg["family"] == "hybrid":
        cfg.update(n_kv_heads=4, hybrid={"attn_every": 1})
    elif cfg.get("moe"):
        cfg.update(n_kv_heads=2, sliding_window=16)
        cfg["moe"] = dict(cfg["moe"], n_experts=4)
    return cfg


def cell_files(cell: str, dtype: str = "bfloat16"):
    """(the cell's entry, its small configuration, its small traffic)."""
    man = manifest.manifest()
    c = manifest.cell(man, cell)
    traffic = manifest.traffic(c["traffic"])
    traffic.update(batch=B, seq_len=S)
    return c, config(c["config"], dtype), traffic
