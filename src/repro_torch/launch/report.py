"""Tables of the dry run's records (the JSON files `launch.dryrun` writes):
per-mesh status, live bytes against the H100's 80 GB and the collective
counts; the roofline terms; the memory deltas against a baseline
directory.

    PYTHONPATH=src python -m repro_torch.launch.report [DIR] [BASELINE_DIR]
"""
from __future__ import annotations

import glob
import json
from pathlib import Path


def load(d):
    out = {}
    for f in glob.glob(f"{d}/*.json"):
        with open(f) as fh:
            out[Path(f).stem] = json.load(fh)
    return out


def fmt_bytes(b):
    return f"{b / 1e9:.2f}"


_MESH_COLS = ("status", "live GB/dev", "fits 80GB", "trace s",
              "collectives (AG/AR/RS/A2A)", "collective TB/dev", "dominant")
_MESH_NAMES = {"__single": "16x16", "__multi": "2x16x16"}


def _mesh_cells(r) -> list:
    """One record's cells of a `dryrun_table` row."""
    if r is None:
        return ["not run"] + ["—"] * (len(_MESH_COLS) - 1)
    if r["status"] == "skipped":
        return ["skipped", "—", "—", "—", r["reason"][:48], "—", "—"]
    if r["status"] != "ok":
        return ["**FAILED**", "—", "—", "—", r["error"][:48], "—", "—"]
    c = r["collectives"]
    coll = "/".join(str(c["counts"].get(k, 0)) for k in
                    ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"))
    return ["ok", fmt_bytes(r["memory"]["live_bytes_per_device"]),
            "yes" if r["memory"]["fits_h100_80GB"] else "**NO**", f"{r['trace_s']}", coll,
            f"{c['bytes_static'] / 1e12:.3f}", r["roofline"]["dominant"].removesuffix("_s")]


def dryrun_table(recs, *mesh_tags: str) -> str:
    """A row an arch x shape recorded under any of `mesh_tags` ("__single",
    "__multi"), each mesh's cells side by side."""
    head = [f"{_MESH_NAMES.get(m, m)} {c}" if len(mesh_tags) > 1 else c
            for m in mesh_tags for c in _MESH_COLS]
    rows = ["| arch | shape | " + " | ".join(head) + " |", "|---|---|" + "---|" * len(head)]
    cells = sorted({tuple(t.rsplit("__", 2)[:2]) for t in recs
                    if any(t.endswith(m) for m in mesh_tags)})
    for arch, shape in cells:
        runs = [recs.get(f"{arch}__{shape}{m}") for m in mesh_tags]
        mb = max(r.get("microbatches", 1) for r in runs if r is not None)
        row = [arch, shape + (f" (mb={mb})" if mb > 1 else "")]
        rows.append("| " + " | ".join(row + [c for r in runs for c in _mesh_cells(r)]) + " |")
    return "\n".join(rows)


def roofline_table(recs) -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | dominant"
            " | bound frac (compute/bound) | MODEL/analytic flops"
            " | coll bytes/dev GB |",
            "|---|---|---|---|---|---|---|---|---|"]
    for tag in sorted(recs):
        r = recs[tag]
        if not tag.endswith("__single") or r["status"] != "ok":
            continue
        arch, shape, _ = tag.rsplit("__", 2)
        t = r["roofline"]
        a = r["analytic"]
        coll_gb = max(r["collectives"]["bytes_trip_weighted"],
                      a["collective_bytes_per_device"]) / 1e9
        rows.append(
            f"| {arch} | {shape} | {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | {t['dominant'][:-2]} "
            f"| {t['roofline_fraction_compute']:.2f} "
            f"| {a['useful_ratio']:.2f} | {coll_gb:.2f} |")
    return "\n".join(rows)


def memory_delta_table(base, final) -> str:
    rows = ["| cell | baseline GB/dev | final GB/dev | Δ |", "|---|---|---|---|"]
    for tag in sorted(final):
        b, f = base.get(tag), final[tag]
        if not (b and b.get("status") == "ok" and f.get("status") == "ok"):
            continue
        bg = b["memory"]["live_bytes_per_device"] / 1e9
        fg = f["memory"]["live_bytes_per_device"] / 1e9
        if abs(bg - fg) / max(bg, 1e-9) > 0.15:
            rows.append(f"| {tag} | {bg:.1f} | {fg:.1f} | {100 * (fg - bg) / bg:+.0f}% |")
    return "\n".join(rows)


def summarize(final) -> dict:
    s = {"ok": 0, "skipped": 0, "failed": 0, "nofit": 0}
    for r in final.values():
        if r["status"] == "ok":
            s["ok"] += 1
            if not r["memory"]["fits_h100_80GB"]:
                s["nofit"] += 1
        elif r["status"] == "skipped":
            s["skipped"] += 1
        else:
            s["failed"] += 1
    return s


def main(argv=None):
    import sys

    argv = sys.argv[1:] if argv is None else argv
    final = load(argv[0] if argv else "experiments/dryrun_torch")
    base = load(argv[1] if len(argv) > 1 else "experiments/dryrun_torch_baseline")
    print("## summary", summarize(final))
    print("\n### single-pod (16x16 = 256 cards)\n")
    print(dryrun_table(final, "__single"))
    print("\n### multi-pod (2x16x16 = 512 cards)\n")
    print(dryrun_table(final, "__multi"))
    print("\n### both meshes\n")
    print(dryrun_table(final, "__single", "__multi"))
    print("\n### roofline (single-pod)\n")
    print(roofline_table(final))
    print("\n### memory deltas vs baseline\n")
    print(memory_delta_table(base, final))


if __name__ == "__main__":
    main()
