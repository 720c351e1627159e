"""The dry-run sweep's records as the markdown table of ``PERF.md``: one
row per arch, one cell per input shape holding, for the one-pod run, peak
and argument GB a rank, TFLOP a rank, the GB a rank puts into collectives
and ``trace_s`` (the two-pod run's, after a "|", where any of its first
four differ), a run's ``--variant`` named after it; then the runs whose
peak passes a card's 80 GB.

    python scripts/dryrun_table.py [DIR]   # default experiments/dryrun_torch
"""
import json
import pathlib
import sys

CARD_BYTES = 80e9                     # an H100's device memory
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _cell(r) -> tuple:
    coll = sum(c["bytes"] for c in r["collectives"].values())
    return (f"{r['peak_bytes'] / 1e9:.1f} / {r['argument_bytes'] / 1e9:.1f}",
            f"{r['flops'] / 1e12:.1f}", f"{coll / 1e9:.1f}",
            f"{r['trace_s']:.0f} s" + (f" ({r['variant']})" if r["variant"]
                                       else ""))


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    root = pathlib.Path(args[0] if args else "experiments/dryrun_torch")
    recs = {}
    for f in sorted(root.glob("*.json")):
        r = json.loads(f.read_text())
        recs[r["arch"], r["shape"], r["multi_pod"]] = r
    print("| arch (mode) | " + " | ".join(SHAPES) + " |")
    print("|---" * (1 + len(SHAPES)) + "|")
    over = []
    for arch in sorted({k[0] for k in recs}):
        cells, mode = [], None
        for shape in SHAPES:
            one, two = (recs.get((arch, shape, p)) for p in (False, True))
            mode = mode or (one or two or {}).get("mode")
            if one is None and two is None:
                cells.append("—")
                continue
            text = "; ".join(_cell(one)) if one else "— (pod1)"
            if two and (not one or _cell(two)[:3] != _cell(one)[:3]):
                text += " \\| pod2 " + "; ".join(_cell(two))
            cells.append(text)
            over += [f"{arch} {shape} {'pod2' if r['multi_pod'] else 'pod1'}"
                     f" {r['peak_bytes'] / 1e9:.1f}" for r in (one, two)
                     if r and r["peak_bytes"] > CARD_BYTES]
        print(f"| {arch} ({mode}) | " + " | ".join(cells) + " |")
    print(f"\n{len(recs)} records; peak over 80 GB a rank in {len(over)}:")
    print("; ".join(over))


if __name__ == "__main__":
    main()
