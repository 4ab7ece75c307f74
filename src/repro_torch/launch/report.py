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


def dryrun_table(recs, mesh_tag: str) -> str:
    rows = ["| arch | shape | status | live GB/dev | fits 80GB | trace s"
            " | collectives (AG/AR/RS/A2A) |",
            "|---|---|---|---|---|---|---|"]
    for tag in sorted(recs):
        r = recs[tag]
        if not tag.endswith(mesh_tag):
            continue
        arch, shape, _ = tag.rsplit("__", 2)
        if r["status"] == "skipped":
            rows.append(f"| {arch} | {shape} | skipped | — | — | — | {r['reason'][:48]} |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | **FAILED** | — | — | — | {r['error'][:48]} |")
            continue
        c = r["collectives"]["counts"]
        coll = "/".join(str(c.get(k, 0)) for k in
                        ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"))
        mb = f" (mb={r['microbatches']})" if r.get("microbatches", 1) > 1 else ""
        rows.append(
            f"| {arch} | {shape}{mb} | ok | {fmt_bytes(r['memory']['live_bytes_per_device'])} "
            f"| {'yes' if r['memory']['fits_h100_80GB'] else '**NO**'} "
            f"| {r['trace_s']} | {coll} |")
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
    print("\n### roofline (single-pod)\n")
    print(roofline_table(final))
    print("\n### memory deltas vs baseline\n")
    print(memory_delta_table(base, final))


if __name__ == "__main__":
    main()
