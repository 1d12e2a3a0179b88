"""Command-line driver.

Mirrors the reference entry point ``TEST_2(run, seg, threads[, diagnostics])``
(ref TEST_2.C:281-286, README.md:22-34), with devices replacing threads:

    python -m npswf.tools.cli run --run 3000 --seg 0 \
        --input nps_segment.npz --calib-root /path/to/calib --out out_wf.npz

Subcommands:
    run             process a raw segment into a WF output file
    synth           generate a synthetic raw segment + calibration (testing)
    validate        plotstats-equivalent output-integrity check
    diagnostics     per-event fitted-waveform plots (ref C15, TEST_2.C:1134-1285)

plus pass-through wrappers for the analysis/maintenance tools (forward
their flags after ``--``): convert-root, convert-wf-root, solver-audit,
e2e-bench, glue-profile, cpu-baseline, derive-fixtures, extract-templates.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def _jax_setup(args):
    import jax
    from npswf.utils.compile_cache import setup_compile_cache
    if getattr(args, "cpu", False):
        jax.config.update("jax_platforms", "cpu")
    if getattr(args, "x64", False):
        jax.config.update("jax_enable_x64", True)
    setup_compile_cache()
    return jax


def _load_calibration(cfg, args):
    from npswf.core.calibration import (CalibrationBundle, EpochManifest,
                                        load_calibration,
                                        synthetic_calibration)
    if args.calib and args.calib.endswith(".npz"):
        return CalibrationBundle.load(args.calib)
    if args.calib:  # manifest root dir or manifest.json
        if args.calib.endswith(".json"):
            manifest = EpochManifest.load(args.calib)
        else:
            manifest = EpochManifest(root=args.calib)
        return load_calibration(cfg, manifest, args.run)
    logging.warning("no --calib given; using synthetic calibration")
    return synthetic_calibration(cfg, run=args.run)


def cmd_run(args) -> int:
    jax = _jax_setup(args)
    from npswf.core.config import config_for_run
    from npswf.io.rawstream import read_segment
    from npswf.runtime.executor import run_segment

    # seg-derived default file names, mirroring the reference's
    # nps_hms_coin_{run}_{seg}... -> nps_production_{run}_{seg}_{threads}...
    # pattern (ref TEST_2.C:290, 301)
    if args.input is None:
        args.input = f"nps_segment_{args.run}_{args.seg}.npz"
    if args.out is None:
        args.out = f"nps_production_{args.run}_{args.seg}_{args.devices}_wf.npz"
    if not os.path.exists(args.input):
        print(f"ERROR: Cannot open file: {args.input}", file=sys.stderr)
        return 2

    cfg = config_for_run(args.run)
    if args.fit_capacity:
        cfg = cfg.replace(fit_capacity=args.fit_capacity)
    if args.search_capacity:
        cfg = cfg.replace(search_capacity=args.search_capacity)
    if args.model:
        cfg = cfg.replace(model_name=args.model)
    cal = _load_calibration(cfg, args)
    seg = read_segment(args.input)
    if args.range:
        lo, hi = args.range
        seg = seg.slice(lo, min(hi, seg.n_events))
    mesh = None
    if args.devices > 1 or args.block_shards > 1:
        from npswf.parallel.mesh import make_mesh
        mesh = make_mesh(cfg, n_data=args.devices, n_block=args.block_shards)
    res = run_segment(cfg, cal, seg, args.out, batch_size=args.batch_size,
                      mesh=mesh, resume=not args.no_resume,
                      use_native_decode=not args.no_native,
                      profile_dir=args.profile,
                      chain_batches=args.chain_batches)
    print(f"processed {res.n_events} events in {res.wall_time:.2f}s "
          f"({res.events_per_sec:.1f} ev/s, {res.blocks_per_sec:.0f} blocks/s)")
    print(f"Total failed fits: {res.n_fit_failure} "
          f"total fits succeed: {res.n_fit_success}")
    return 0


def cmd_synth(args) -> int:
    _jax_setup(args)
    from npswf.core.config import config_for_run
    from npswf.core.calibration import synthetic_calibration
    from npswf.utils.synthetic import make_events, synthetic_segment
    from npswf.io.rawstream import write_segment

    cfg = config_for_run(args.run)
    cal = synthetic_calibration(cfg, run=args.run, seed=args.seed)
    truth = make_events(cfg, cal, args.events, occupancy=args.occupancy,
                        max_pulses=args.max_pulses, seed=args.seed)
    seg = synthetic_segment(cfg, truth, seed=args.seed,
                            first_evt=args.first_evt, run=args.run)
    write_segment(args.out, seg)
    if args.calib_out:
        cal.save(args.calib_out)
    print(f"wrote {args.events} synthetic events to {args.out}"
          + (f" and calibration to {args.calib_out}" if args.calib_out else ""))
    return 0


def cmd_parity(args) -> int:
    from npswf.tools.parity import run_parity
    report = run_parity(args.ref, args.ours, dt_ns=args.dt,
                        time_tol_bins=args.time_tol_bins,
                        json_out=args.json)
    return 0 if report["pass"] else 1


def cmd_validate(args) -> int:
    from npswf.tools.plotstats import main as plotstats_main
    return plotstats_main([args.wf_file] + (["--verbose"] if args.verbose else []))


def cmd_diagnostics(args) -> int:
    _jax_setup(args)
    from npswf.tools.diagnostics import make_event_plots
    n = make_event_plots(args.wf_file, args.input, args.calib, args.outdir,
                         events=args.events)
    print(f"wrote {n} diagnostic pages to {args.outdir}")
    return 0


# Tools with their own argparse mains, surfaced as pass-through subcommands
# (``npswf <name> -- --their-flags``). Each value is (module, help).
_DELEGATED = {
    "convert-root": ("npswf.tools.convert_root",
                     "ROOT raw file -> segment .npz bridge (needs uproot)"),
    "convert-wf-root": ("npswf.tools.convert_wf_to_root",
                        "WF .npz -> ROOT WF-tree bridge (needs uproot; "
                        "ref TEST_2.C:1383-1432 output format)"),
    "solver-audit": ("npswf.tools.solver_audit",
                     "classify LM fit failures vs an independent scipy-TRF "
                     "solve on adversarial ensembles"),
    "e2e-bench": ("npswf.tools.e2e_bench",
                  "host-I/O-inclusive run_segment benchmark "
                  "(decode/upload/dispatch/fetch/write stage medians)"),
    "glue-profile": ("npswf.tools.glue_profile",
                     "trace-time stage ablation of one pipeline batch"),
    "cpu-baseline": ("npswf.tools.cpu_baseline",
                     "measured single-thread CPU reference denominator "
                     "(golden search + scipy TRF per block)"),
    "derive-fixtures": ("npswf.tools.derive_fixtures",
                        "re-derive the Decimal SearchHighRes fixture file"),
    "extract-templates": ("npswf.tools.extract_templates",
                          "build per-block reference-waveform calibration "
                          "from clean single-pulse events in a raw segment"),
}


def _make_delegate(module_name: str):
    def _run(args) -> int:
        import importlib
        import inspect
        mod = importlib.import_module(module_name)
        rest = list(args.tool_args)
        if rest and rest[0] == "--":
            rest = rest[1:]
        # dispatch on the tool's signature (cpu_baseline has a zero-arg
        # main) — never on a caught TypeError, which would misclassify
        # TypeErrors raised inside the tool and re-run it
        if inspect.signature(mod.main).parameters:
            return int(mod.main(rest) or 0)
        if rest:
            print(f"ERROR: {module_name} takes no arguments", file=sys.stderr)
            return 2
        return int(mod.main() or 0)
    return _run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="npswf", description=__doc__)
    ap.add_argument("-v", "--verbose", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="process a raw segment")
    p.add_argument("--run", type=int, default=3000)
    p.add_argument("--seg", type=int, default=0,
                   help="segment number; names the default --input/--out "
                        "(the reference's file-name pattern, TEST_2.C:290, 301)")
    p.add_argument("--input", default=None,
                   help="raw segment .npz (default: nps_segment_{run}_{seg}.npz)")
    p.add_argument("--calib", default=None,
                   help=".npz bundle, manifest .json, or calibration root dir")
    p.add_argument("--out", default=None,
                   help="WF output .npz (default: "
                        "nps_production_{run}_{seg}_{devices}_wf.npz)")
    p.add_argument("--model", default=None,
                   help="waveform model family (default spline_ref; "
                        "see npswf.models)")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--chain-batches", type=int, default=1,
                   help="batches per device dispatch (lax.scan chain)")
    p.add_argument("--devices", type=int, default=1)
    p.add_argument("--block-shards", type=int, default=1)
    p.add_argument("--fit-capacity", type=int, default=0)
    p.add_argument("--search-capacity", type=int, default=0,
                   help="max searched lanes per batch (sparse-readout "
                        "compaction); present lanes beyond it are counted "
                        "in n_search_dropped, never silently dropped")
    p.add_argument("--range", type=int, nargs=2, metavar=("LO", "HI"),
                   help="process only events [LO, HI) of the segment "
                        "(the reference's df.Range subset mode)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--no-native", action="store_true",
                   help="disable the C++ decoder (numpy fallback)")
    p.add_argument("--profile", default=None,
                   help="write a JAX profiler trace to this directory")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--x64", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("synth", help="generate synthetic segment + calibration")
    p.add_argument("--events", type=int, default=64)
    p.add_argument("--run", type=int, default=3000)
    p.add_argument("--occupancy", type=float, default=0.05)
    p.add_argument("--max-pulses", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--first-evt", type=int, default=1)
    p.add_argument("--out", required=True)
    p.add_argument("--calib-out", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--x64", action="store_true")
    p.set_defaults(fn=cmd_synth)

    p = sub.add_parser(
        "parity", help="per-pulse time/amp/chi2 residuals vs a reference WF "
                       "file (ROOT via uproot, or another WF .npz)")
    p.add_argument("--ref", required=True)
    p.add_argument("--ours", required=True)
    p.add_argument("--dt", type=float, default=4.0, help="ns per bin")
    p.add_argument("--time-tol-bins", type=float, default=0.05)
    p.add_argument("--json", default=None, help="write the full report here")
    p.set_defaults(fn=cmd_parity)

    p = sub.add_parser("validate", help="output-integrity check (plotstats)")
    p.add_argument("wf_file")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("diagnostics", help="per-event fit plots")
    p.add_argument("wf_file")
    p.add_argument("--input", required=True)
    p.add_argument("--calib", required=True)
    p.add_argument("--outdir", default="figures")
    p.add_argument("--events", type=int, nargs="*", default=None)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--x64", action="store_true")
    p.set_defaults(fn=cmd_diagnostics)

    for name, (module, help_text) in _DELEGATED.items():
        p = sub.add_parser(name, help=help_text)
        p.add_argument("tool_args", nargs=argparse.REMAINDER,
                       help="arguments forwarded to the tool "
                            "(see `npswf %s -- --help`)" % name)
        p.set_defaults(fn=_make_delegate(module))
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
