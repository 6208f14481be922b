"""§Roofline: three-term roofline per (arch x shape x mesh) from the
dry-run artefacts (results/dryrun/*.json).

    compute    = HLO_FLOPs_per_device / peak_bf16      (197 TFLOP/s)
    memory     = HLO_bytes_per_device / hbm_bw         (819 GB/s)
    collective = collective_bytes_per_device / link_bw (50 GB/s)

plus the dominant term, MODEL_FLOPS/HLO_FLOPs usefulness ratio, and a
next-lever note per cell. Emits results/benchmarks/roofline.csv and a
markdown table (results/benchmarks/roofline.md) that EXPERIMENTS.md embeds.

Counterpart of the reference's ``benchmarks/roofline_report.py``: the same
``analyse_cell``, ``load_cells``, ``to_markdown`` and ``run``, with the
artefact and output directories read at call time (``$REPRO_DRYRUN_OUT``,
``$REPRO_BENCH_OUT``). The reference's pod cells (meshes ``pod16x16``,
``pod2x16x16``) are priced with ``TPU_V5E`` as there; the port's cells
(``launch.dryrun``: meshes ``h100x1``, ``h100x16x16``, ``h100x2x16x16``)
with ``H100_SXM`` (989 TFLOP/s bf16, 3.35 TB/s), each mesh in a table of
its own. The collective term divides the per-device collective bytes by the
spec's ``ici_bw``, one link's rate each way, as the reference divides by one
v5e ICI link's 50 GB/s: for ``H100_SXM`` one NVLink4 link, 450 GB/s / 18 =
25 GB/s (a pod wired all by NVLink; across InfiniBand nodes a card has
about 50 GB/s in all). Without artefacts ``run`` reports that none were
found.
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.hw import TPU_V5E
from repro_torch.hw.h100 import H100_SXM
from repro_torch.launch.mesh import H100X1, H100X2X16X16, H100X16X16

from repro_torch.benchmarks.common import Row, results_dir, timed, write_csv

NEXT_LEVER = {
    "compute": "raise arithmetic efficiency: reduce remat/recompute, bigger microbatch GEMMs",
    "memory": "cut HBM traffic: fuse activations, cache-friendly layouts, lower-precision cache",
    "collective": "reshard to remove all-gathers; overlap collectives with compute",
}


# the port's dry-run meshes, priced with H100_SXM, each with its table title
PORT_MESHES = {
    H100X1.name: "One H100 (h100x1), priced with H100_SXM — the port's dry run",
    H100X16X16.name: "16 x 16 H100s (h100x16x16), priced with H100_SXM — the port's pod dry run",
    H100X2X16X16.name: "2 x 16 x 16 H100s (h100x2x16x16), priced with H100_SXM",
}


def artefacts_dir() -> str:
    """Where ``load_cells`` looks by default: ``$REPRO_DRYRUN_OUT``, else
    ``results/dryrun`` under the working directory."""
    return os.environ.get("REPRO_DRYRUN_OUT", "results/dryrun")


def analyse_cell(rec: dict) -> dict | None:
    if not rec.get("applicable", True) or not rec.get("ok"):
        return None
    spec = H100_SXM if rec["mesh"] in PORT_MESHES else TPU_V5E
    n_dev = rec["n_devices"]
    flops = rec["hlo_flops_per_device"]
    bytes_ = rec["hlo_bytes_per_device"]
    coll = rec["collective_bytes_per_device"]
    t_c = flops / spec.peak_flops_bf16
    t_m = bytes_ / spec.hbm_bw
    t_x = coll / spec.ici_bw
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x), key=lambda kv: kv[1])[0]
    model_flops = rec["model_flops_per_step"]
    useful = model_flops / max(flops * n_dev, 1.0)
    t_bound = max(t_c, t_m, t_x)
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "t_compute_s": t_c,
        "t_memory_s": t_m,
        "t_collective_s": t_x,
        "dominant": dom,
        "t_bound_s": t_bound,
        "model_flops_per_step": model_flops,
        "hlo_flops_global": flops * n_dev,
        "useful_flops_ratio": useful,
        "collective_count": rec.get("collective_count", 0),
        "next_lever": NEXT_LEVER[dom],
    }


def load_cells(dryrun_dir: str | None = None):
    """Prefer exact-accounting (unrolled) artefacts; fall back to scanned
    ones (which undercount while-body costs — see dryrun docstring)."""
    by_cell = {}
    for path in sorted(glob.glob(os.path.join(dryrun_dir or artefacts_dir(), "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        key = (rec.get("arch"), rec.get("shape"), rec.get("mesh"))
        unrolled = rec.get("unrolled_accounting", False)
        if key not in by_cell or (unrolled and not by_cell[key].get("unrolled_accounting")):
            if rec.get("ok") or key not in by_cell:
                by_cell[key] = rec
    cells = []
    for rec in by_cell.values():
        row = analyse_cell(rec)
        if row:
            row["accounting"] = "unrolled" if rec.get("unrolled_accounting") else "scanned"
            cells.append(row)
    return sorted(cells, key=lambda c: (c["arch"], c["shape"], c["mesh"]))


def to_markdown(cells) -> str:
    hdr = (
        "| arch | shape | mesh | compute (ms) | memory (ms) | collective (ms) "
        "| dominant | useful FLOPs | acct | next lever |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for c in cells:
        lines.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} "
            f"| {c['t_compute_s']*1e3:.2f} | {c['t_memory_s']*1e3:.2f} "
            f"| {c['t_collective_s']*1e3:.2f} | **{c['dominant']}** "
            f"| {c['useful_flops_ratio']:.2f} | {c.get('accounting','scanned')[:3]} "
            f"| {c['next_lever']} |"
        )
    return hdr + "\n".join(lines) + "\n"


def run() -> list[Row]:
    def build():
        cells = load_cells()
        single = [c for c in cells if c["mesh"] == "pod16x16"]
        multi = [c for c in cells if c["mesh"] == "pod2x16x16"]
        card = [c for c in cells if c["mesh"] == H100X1.name]
        port = {m: [c for c in cells if c["mesh"] == m] for m in PORT_MESHES}
        if cells:
            write_csv(
                "roofline",
                list(cells[0]),
                [[c[k] for k in cells[0]] for c in cells],
            )
            out = results_dir()
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, "roofline.md"), "w") as f:
                f.write("## Single-pod (16x16) baseline roofline — the §Roofline table\n\n")
                f.write(to_markdown(single))
                f.write("\n## Multi-pod (2x16x16) — pod-axis sharding check\n\n")
                f.write(to_markdown(multi))
                for mesh, title in PORT_MESHES.items():
                    if port[mesh]:
                        f.write(f"\n## {title}\n\n")
                        f.write(to_markdown(port[mesh]))
        return cells, single, multi, card, port

    (cells, single, multi, card, port), us = timed(build)
    if not cells:
        return [("roofline_report", us, "no dryrun artefacts found (run repro.launch.dryrun)")]
    doms = {}
    for c in single + card:
        doms[c["dominant"]] = doms.get(c["dominant"], 0) + 1
    derived = (
        f"single_pod_cells={len(single)};multi_pod_cells={len(multi)};"
        + (f"one_card_cells={len(card)};" if card else "")
        + "".join(f"{m}_cells={len(port[m])};" for m in (H100X16X16.name, H100X2X16X16.name)
                  if port[m])
        + ";".join(f"{k}={v}" for k, v in sorted(doms.items()))
    )
    return [("roofline_report", us, derived)]
