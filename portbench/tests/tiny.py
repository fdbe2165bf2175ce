"""Cells cut to a size the CPU tests can hold: the benchmark's own
configuration and mix files with their widths, depth, batch and pool
made small."""

import json

from portbench.harness import spec

CELLS = ("bert-base-mlm.terngrad.b32", "resnet50-gn-imagenet.eftopk.b128",
         "bert-base-mlm.identity.b32", "resnet50-gn-imagenet.identity.b128")
TIGHT = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}


def config(name: str, compute: str = "float32") -> dict:
    with open(spec.HERE / "configs" / f"{name}.json") as f:
        cfg = json.load(f)
    if cfg["family"] == "bert":
        cfg.update(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=128,
                   max_position_embeddings=64, compute_dtype=compute,
                   attention="full")
    else:
        cfg.update(stage_sizes=[1, 1, 1, 1], num_filters=8, num_classes=10,
                   image_size=32)
    return cfg


def mix(traffic: str) -> dict:
    with open(spec.HERE / "traffic" / f"{traffic}.json") as f:
        m = json.load(f)
    m.update(batch=4, pool=4)
    if "seq" in m:
        m["seq"] = 64
    if m["bucket_mb"]:
        m["bucket_mb"] = 0.01  # several buckets of tiny leaves
    return m


def cell(workload: str, compute: str = "float32", limits=None):
    """A tiny copy of ``workload`` with its metrics; ``compute`` the BERT
    family's product type (float32 agrees with the reference to
    rounding on the CPU)."""
    bench = spec.benchmark()
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    return spec.make(
        workload, 1, config(w["config"], compute), mix(w["traffic"]),
        [m for m in bench["end_to_end"] if spec.applies(m, workload)],
        [m for m in bench["per_layer"] if spec.applies(m, workload)],
        dict(limits or TIGHT))
