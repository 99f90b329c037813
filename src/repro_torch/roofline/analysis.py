"""Three-term roofline for one step on one NVIDIA H100 SXM.

Port of ``repro.roofline.analysis`` with the H100's constants in place of
the TPU v5e's:

    compute    = FLOPs_total        / (chips * BF16_PEAK)
    memory     = bytes_total        / (chips * HBM_BW)
    collective = collective_bytes   / (chips * LINK_BW)

The counts come from ``roofline.counts`` (a traced step on the meta device,
per device), not from XLA's HLO.  On one device the step moves no
collective bytes, so the collective term is 0; on a mesh (``launch/dryrun.py
--mesh``) it is the collective result bytes per device over one link.
Pure Python: importing this module loads no torch.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit:
BF16_PEAK = 989e12        # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12          # HBM3 bytes/s (80 GB)
HBM_BYTES = 80e9          # device memory
# The production meshes' 'model' axis is 16 wide: two nodes of 8 H100s, so
# its collectives cross the nodes' network, one 400 Gb/s NDR InfiniBand
# adapter per GPU (NVIDIA ConnectX-7, as in the DGX H100), not NVLink (900
# GB/s per GPU inside a node).  The term divides a device's collective bytes
# by that one link.
LINK_BW = 400e9 / 8       # bytes/s per GPU


def terms(flops: float, nbytes: float, collective_bytes: float) -> dict:
    """The three terms in seconds, from per-device counts."""
    return {"compute": flops / BF16_PEAK, "memory": nbytes / HBM_BW,
            "collective": collective_bytes / LINK_BW}


def analyze(counts: dict, *, chips: int = 1, model_flops_total: float) -> dict:
    """Roofline record for one (arch × shape) cell from its per-device
    ``counts`` (``roofline.counts.count_step``: ``flops``, ``bytes``,
    ``collective_bytes`` and the ``memory`` record).  JAX's record keys
    that still mean something: ``per_device``, ``totals``,
    ``terms_seconds``, ``dominant``, ``model_flops``, ``useful_flop_ratio``,
    ``roofline_fraction``; ``memory`` takes the place of
    ``memory_analysis``."""
    flops_dev = counts["flops"]
    bytes_dev = counts["bytes"]
    coll_dev = counts.get("collective_bytes", 0.0)
    t = terms(flops_dev, bytes_dev, coll_dev)
    bound = max(t.values())
    useful_ratio = (model_flops_total / (flops_dev * chips)) if flops_dev else 0.0
    # roofline fraction: time the useful math would take at peak / bound time
    ideal = (model_flops_total / chips) / BF16_PEAK
    return {
        "chips": chips,
        "per_device": {"flops": flops_dev, "bytes": bytes_dev,
                       "collective_bytes": coll_dev},
        "totals": {"flops": flops_dev * chips, "bytes": bytes_dev * chips,
                   "collective_bytes": coll_dev * chips},
        "collectives": counts.get("collectives"),
        "terms_seconds": t,
        "dominant": max(t, key=t.get),
        "model_flops": model_flops_total,
        "useful_flop_ratio": useful_ratio,
        "roofline_fraction": ideal / bound if bound > 0 else 0.0,
        "memory": counts["memory"],
    }


def model_flops_for(cfg, shape) -> float:
    """6·N·D for train (fwd+bwd), 2·N·D for prefill, 2·N·B per decode step.

    N = active params (MoE: top-k experts only).  The standard MFU
    convention; attention score FLOPs are excluded (reported separately by
    the useful_flop_ratio discussion).
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one decode token per sequence
