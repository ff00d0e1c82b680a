"""Results report generator CLI.

The analog of the reference's update_readme.py: collect pipe-delimited
out_<scene>.txt records (ours and optionally the reference's own — same
format) and emit a RESULTS.md with per-scene tables, speedups, and the
published reference baselines for comparison.

Usage:
    python -m rays1bench.bench.report_cli --dirs out_jax,out_ref \
        --out RESULTS.md
"""

from __future__ import annotations

import argparse

from rays1bench.bench import report

# Published reference results (README.md:40-84; machine: i9 9900K 8c/16t,
# MSVC 2019; see BASELINE.md). Used as comparison rows.
REFERENCE_PUBLISHED = {
    "large": [
        report.Record("ref step1 (scalar)", 58.601, 25_236_618, 0.431),
        report.Record("ref step12 (AVX2)", 3.842, 25_241_334, 6.570),
        report.Record("ref step13 (16 threads)", 10.628, 630_931_100, 59.362),
    ],
    "medium": [
        report.Record("ref step1 (scalar)", 6.017, 23_083_633, 3.837),
        report.Record("ref step12 (AVX2)", 1.051, 23_087_117, 21.960),
        report.Record("ref step13 (16 threads)", 2.679, 577_132_771, 215.403),
    ],
    "small": [
        report.Record("ref step1 (scalar)", 0.973, 17_005_555, 17.483),
        report.Record("ref step12 (AVX2)", 0.501, 16_572_334, 33.057),
        report.Record("ref step13 (16 threads)", 1.289, 414_187_797, 321.238),
    ],
}


# The reference's published FULL-workload best (step13 MT, 250 spp @ 50
# bounces — the same rows as above's step13 entries, kept separate so the
# full-workload tables lead with the apples-to-apples comparison).
REFERENCE_FULL = {
    "large": [report.Record("ref step13 (i9 9900K, 16 threads)", 10.628,
                            630_931_100, 59.362)],
    "medium": [report.Record("ref step13 (i9 9900K, 16 threads)", 2.679,
                             577_132_771, 215.403)],
    "small": [report.Record("ref step13 (i9 9900K, 16 threads)", 1.289,
                            414_187_797, 321.238)],
}

def scene_table(dirs, scene, include_reference=True) -> str:
    recs = list(REFERENCE_PUBLISHED.get(scene, [])) if include_reference else []
    recs += report.collect(dirs, scene)
    return report.markdown_table(recs) if recs else ""


def full_table(dirs, scene, include_reference=True) -> str:
    """Full-workload (250 spp @ 50 bounces) table: the reference's own
    published step13 row first, then the collected records."""
    recs = list(REFERENCE_FULL.get(scene, [])) if include_reference else []
    recs += report.collect(dirs, scene)
    return report.markdown_table(recs) if recs else ""


def scaling_table(path) -> str:
    """Scaling-sweep records (records/scaling/sweep.txt,
    `label|devices|seconds|rays|mrays|eff|` one per line, written by
    bench/scaling.py --record) -> markdown."""
    import os
    if not os.path.exists(path):
        return ""
    lines = ["| workload / engine | devices | mrays/s | efficiency |",
             "|---|---|---|---|"]
    with open(path) as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 6 or not parts[0]:
                continue
            try:
                mrays, eff = float(parts[4]), float(parts[5])
            except ValueError:
                continue  # skip malformed rows, like the length guard above
            lines.append(f"| {parts[0]} | {parts[1]} | {mrays:.2f}"
                         f" | {eff:.0%} |")
    return "\n".join(lines)


def generate(dirs, scenes, include_reference=True) -> str:
    lines = ["# Benchmark results", ""]
    for scene in scenes:
        table = scene_table(dirs, scene, include_reference)
        if not table:
            continue
        lines.append(f"## {scene}")
        lines.append("")
        lines.append(table)
        lines.append("")
    return "\n".join(lines)


def build_subs(dirs, scenes, include_reference=True,
               full_dirs=("records/full_ref_box", "records/full"),
               scaling_path="records/scaling/sweep.txt") -> dict:
    """All template placeholders, from records only (no hand data):
    __RESULTS_<SCENE>__ (10-bounce workload ladder tables),
    __RESULTS_FULL_<SCENE>__ (250 spp @ 50 bounces ladder tables) and
    __RESULTS_SCALING__."""
    subs = {f"__RESULTS_{s.upper()}__": scene_table(dirs, s,
                                                    include_reference)
            for s in scenes}
    for s in scenes:
        subs[f"__RESULTS_FULL_{s.upper()}__"] = full_table(
            list(full_dirs), s, include_reference)
    subs["__RESULTS_SCALING__"] = scaling_table(scaling_path)
    return subs


def generate_from_template(template_path, out_path, dirs, scenes,
                           include_reference=True, **kw) -> str:
    """Regenerate a results file from a template with __RESULTS_*__
    placeholders — the reference's README regeneration flow
    (update_readme.py:49-69), applied to RESULTS.md and README.md."""
    subs = build_subs(dirs, scenes, include_reference, **kw)
    report.render_template(template_path, out_path, subs)
    with open(out_path) as f:
        return f.read()


def main(argv=None):
    import os
    ap = argparse.ArgumentParser(prog="rays1bench.bench.report_cli")
    ap.add_argument("--dirs", default="records/ref_matched,records",
                    help="comma-separated dirs with out_<scene>.txt records")
    ap.add_argument("--scenes", default="large,medium,small")
    ap.add_argument("--out", default="RESULTS.md")
    ap.add_argument("--template", default="RESULTS_template.md",
                    help="prose template with __RESULTS_<SCENE>__ "
                         "placeholders; plain table mode if absent")
    ap.add_argument("--no-reference", action="store_true",
                    help="omit the published reference rows")
    ap.add_argument("--readme-template", default="README_template.md",
                    help="when present, README.md is regenerated from it "
                         "too (same placeholder substitution) — the "
                         "reference's update_readme.py flow")
    ap.add_argument("--readme-out", default="README.md")
    args = ap.parse_args(argv)
    dirs = args.dirs.split(",")
    scenes = args.scenes.split(",")
    if os.path.exists(args.template):
        text = generate_from_template(args.template, args.out, dirs, scenes,
                                      include_reference=not args.no_reference)
    else:
        text = generate(dirs, scenes,
                        include_reference=not args.no_reference)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    if os.path.exists(args.readme_template):
        generate_from_template(args.readme_template, args.readme_out, dirs,
                               scenes,
                               include_reference=not args.no_reference)
        print(f"(regenerated {args.readme_out} from {args.readme_template})")


if __name__ == "__main__":
    main()
