"""Multi-pod dry-run: the per-cell record of every (arch x shape x mesh)
cell, composed on the host.

The port of the JAX package's ``launch/dryrun.py``.  JAX's lowers and
compiles each cell's step on the production meshes (16x16 single-pod,
2x16x16 multi-pod) against allocation-free inputs and writes what the
compiler reports.  The port has no compiler; it builds the same step
(:func:`build_lowerable`: the port's ``meta`` specs, the sharding policy on
:func:`~repro_torch.launch.mesh.make_production_mesh`'s abstract mesh, the
step function, not run) and writes one ``{arch}__{shape}__{mesh}.json``
under ``--out`` with what can be composed exactly from it:

* ``arch``, ``shape``, ``mesh``, ``status`` (``ok`` / ``skipped`` /
  ``error``), ``reason`` of a skip (``cell_is_skipped``), ``n_devices``,
  ``total_s``: as JAX's;
* ``analytical_flops_global``, ``analytical_flops_ideal``,
  ``model_flops_6nd``, ``analytical_bytes_global``:
  :mod:`repro_torch.launch.analysis`, as JAX's;
* ``argument_size_in_bytes``: the bytes one device holds of the step's
  arguments, the sum over every argument leaf of its ``shard_shape``
  times its itemsize;
* ``moves`` (train cells): the bytes one step of the port's mesh train
  step (``training/train_step.py``) copies between positions and between
  devices, by kind (``gather``, ``reduce``, ``scatter``, ``relayout``,
  ``model``, ``routes``, as ``MeshStepStats`` counts them when the step
  runs), at ``cfg.train_accum`` and the shape's batch and sequence length
  (:func:`~repro_torch.training.train_step.mesh_step_moves`): each
  period's parameters gathered in the forward and again in the backward
  pass, every family's products split over ``model``, a microbatch over
  the data rows JAX's ``_fit`` gives it (mixtral's and jamba's 16 rows
  over 2x16x16's ``data`` rows, ``pod`` dropped).  The sorted MoE
  dispatch (``moe_dispatch="sorted"``, which no registry config sets;
  ``run_cell(..., cfg=)`` composes a cell with it, as JAX's hillclimbed
  phi3.5-moe ``train_4k`` cell) splits its experts' ``d_ff`` too and
  books each data row's per-expert counts to the next row of its
  microbatch under ``routes``.  They are the port's schedule, not GSPMD's
  collectives.
  Where ``train_accum`` does not divide the global batch, the step
  raises and the record says so under ``moves_reason`` instead (no
  registry cell).  Prefill and decode have no mesh step in the port: no
  ``moves``.

JAX's record has these keys too, which the port leaves out:

* ``lower_s``, ``compile_s``: nothing is lowered or compiled;
* ``output_size_in_bytes``, ``temp_size_in_bytes``,
  ``alias_size_in_bytes``, ``generated_code_size_in_bytes``: XLA's
  ``memory_analysis`` of a compiled program (its buffer assignment, its
  fusion, its code); the port's eager step has no such program.  Running
  the step on ``meta`` tensors is no way round: at ``prefill_32k`` the
  chunked attention is 64 x 64 chunk pairs a layer and the time scans one
  Python iteration a token, minutes a cell;
* ``flops_per_device``, ``bytes_per_device``: XLA's ``cost_analysis``;
* ``collectives``: parsed from the partitioned HLO, which the port does
  not have (``moves`` is its own schedule's counterpart);
* the four ``*_corrected`` fields: JAX's counts take a scanned body once
  and are extrapolated from one and two periods; the port's counts cover
  every period directly, so there is no undercount to correct.

``benchmarks/roofline.py`` ``derive`` reads such a record on its
analytical FLOPs (its ``.get(..., 0.0)`` defaults).  The dry-run
allocates nothing and touches no device.  :func:`parse_collectives` and
:func:`_shape_bytes` are the JAX package's text tools, copied.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k \\
      --mesh single_pod
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import time
import traceback

__all__ = ["parse_collectives", "build_lowerable", "argument_bytes",
           "run_cell", "main"]

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2,
    "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"(f64|f32|f16|bf16|f8e4m3|f8e5m2|s64|s32|s16|s8|u64"
                       r"|u32|u16|u8|pred|c64|c128)\[([0-9,]*)\]")

MOVES_SCHEDULE = ("repro_torch mesh train step (MeshStepStats): bytes "
                  "copied between positions and between devices, not "
                  "GSPMD collectives; parameters gathered a period at a "
                  "time (forward and recomputation), the encoder's once, "
                  "every family's products split over model (kind "
                  "model); a microbatch over the data rows _fit gives it, "
                  "each distinct slice run once, on the lowest row; the "
                  "sorted MoE dispatch's expert counts row to row (kind "
                  "routes)")


def _shape_bytes(text: str) -> int:
    """Sum byte sizes of every typed shape literal in `text`."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> dict:
    """Per-device collective bytes/counts by op type from partitioned HLO."""
    stats = {op: {"count": 0, "bytes": 0} for op in _COLLECTIVES}
    for line in hlo_text.splitlines():
        ls = line.strip()
        m = re.match(r"(?:ROOT )?%?[\w.\-]+ = (.*?) (\S+)\(", ls)
        if not m:
            continue
        result_part, opname = m.groups()
        opname = opname.split(".")[0]
        for op in _COLLECTIVES:
            if opname == op or opname.startswith(op + "-"):
                # `-start` variants carry the payload; `-done` repeats the
                # shape — count only starts and plain (synchronous) forms.
                if opname.endswith("-done"):
                    continue
                stats[op]["count"] += 1
                stats[op]["bytes"] += _shape_bytes(result_part)
                break
    stats["total_bytes"] = sum(
        v["bytes"] for k, v in stats.items() if isinstance(v, dict))
    stats["total_count"] = sum(
        v["count"] for k, v in stats.items() if isinstance(v, dict))
    return stats


def build_lowerable(arch: str, shape_name: str, mesh, cfg=None):
    """Return ``(fn, args, in_shardings, donate, out_shardings)`` as JAX's
    does: the cell's step function (not run), its ``meta`` arguments and
    their ``NamedSharding`` trees on ``mesh``."""
    from repro_torch.configs.registry import get_config, input_specs
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import lm
    from repro_torch.models.sharding import (NamedSharding, P,
                                             batch_shardings, cache_shardings,
                                             param_shardings,
                                             set_activation_mesh,
                                             set_sp_outputs)
    from repro_torch.training.optimizer import AdamW, AdamWState
    from repro_torch.training.train_step import (TrainState, make_train_step,
                                                 state_specs)

    cfg = cfg or get_config(arch)
    set_activation_mesh(mesh)
    set_sp_outputs(cfg.sp_reduce_scatter)
    spec = SHAPES[shape_name]
    specs = input_specs(arch, shape_name, cfg)
    p_specs = lm.param_specs(cfg)
    p_sh = param_shardings(mesh, p_specs)

    if spec.kind == "train":
        opt = AdamW()
        st_specs = state_specs(cfg, opt)
        st_sh = TrainState(
            params=p_sh,
            opt=AdamWState(step=NamedSharding(mesh, P()),
                           m=param_shardings(mesh, st_specs.opt.m),
                           v=param_shardings(mesh, st_specs.opt.v)),
            err=None)
        batch = dict(specs)
        b_sh = batch_shardings(mesh, batch)
        fn = make_train_step(cfg, opt, grad_shardings=p_sh)
        return fn, (st_specs, batch), (st_sh, b_sh), 0, (st_sh, None)
    if spec.kind == "prefill":
        tokens = specs["tokens"]
        b_sh = batch_shardings(mesh, dict(specs))
        max_len = spec.seq_len + (cfg.frontend_len
                                  if cfg.frontend == "vision_stub" else 0)

        def fn(params, tokens, frontend=None):
            return lm.prefill(cfg, params, tokens, max_len,
                              frontend=frontend)

        args = (p_specs, tokens) + ((specs["frontend"],)
                                    if "frontend" in specs else ())
        shardings = (p_sh, b_sh["tokens"]) + ((b_sh["frontend"],)
                                              if "frontend" in specs else ())
        mem_len = cfg.frontend_len if cfg.cross_attention else 0
        c_out = cache_shardings(
            mesh, lm.cache_specs(cfg, spec.global_batch, max_len,
                                 memory_len=mem_len))
        return fn, args, shardings, None, (None, c_out)
    # decode
    cache = specs["cache"]
    c_sh = cache_shardings(mesh, cache)
    b_sh = batch_shardings(mesh, {"tokens_last": specs["tokens_last"],
                                  "pos": specs["pos"]})

    def fn(params, cache, tokens_last, pos):
        return lm.decode_step(cfg, params, cache, tokens_last, pos)

    return (fn, (p_specs, cache, specs["tokens_last"], specs["pos"]),
            (p_sh, c_sh, b_sh["tokens_last"], b_sh["pos"]), 1, (None, c_sh))


def argument_bytes(args, shardings) -> int:
    """The bytes one device holds of ``args``: every leaf's
    ``shard_shape`` under its sharding (the trees walked together: dicts,
    tuples, ``None``) times its itemsize."""
    if args is None:
        return 0
    if isinstance(args, dict):
        return sum(argument_bytes(v, shardings[k]) for k, v in args.items())
    if isinstance(args, tuple):
        return sum(argument_bytes(a, s) for a, s in zip(args, shardings,
                                                        strict=True))
    return (math.prod(shardings.shard_shape(tuple(args.shape)))
            * args.element_size())


def _moves(cfg, shape_name: str, mesh) -> dict:
    """``{"moves": ...}`` of a train cell at the step's default
    accumulation, or ``{"moves_reason": ...}`` where the step raises."""
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.training.train_step import mesh_step_moves

    try:
        shape = SHAPES[shape_name]
        moved = mesh_step_moves(cfg, mesh, cfg.train_accum,
                                shape.global_batch, shape.seq_len)
    except ValueError as e:
        return {"moves_reason": str(e)}
    return {"moves": {"schedule": MOVES_SCHEDULE, "accum": cfg.train_accum,
                      **{k: v._asdict() for k, v in moved._asdict().items()}}}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             save_hlo: bool = False, correct: bool = True,
             cfg=None) -> dict:
    """Compose and write one cell's record (``cfg``: the arch's config
    with a lever set, as :func:`build_lowerable` takes it; default the
    registry's).  ``save_hlo`` raises (the port has no HLO); ``correct``
    is JAX's scan-undercount switch and changes nothing here (nothing is
    undercounted)."""
    from repro_torch.configs.registry import cell_is_skipped, get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.analysis import analytical_bytes, analytical_flops
    from repro_torch.launch.mesh import make_production_mesh

    if save_hlo:
        raise ValueError("the port compiles no program: there is no HLO "
                         "to save")
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
              "status": "ok"}
    skip = cell_is_skipped(arch, shape_name)
    if skip:
        record["status"] = "skipped"
        record["reason"] = skip
        _save(record, out_dir)
        return record

    t0 = time.time()
    cfg = cfg or get_config(arch)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi_pod"))
    _, args, shardings, _, _ = build_lowerable(arch, shape_name, mesh, cfg)
    record["argument_size_in_bytes"] = argument_bytes(args, shardings)
    if SHAPES[shape_name].kind == "train":
        record.update(_moves(cfg, shape_name, mesh))
    record["n_devices"] = mesh.size

    fr = analytical_flops(cfg, shape_name)
    record["analytical_flops_global"] = fr.total
    record["analytical_flops_ideal"] = fr.ideal
    record["model_flops_6nd"] = fr.model_flops_6nd
    record["analytical_bytes_global"] = analytical_bytes(cfg, shape_name)
    record["total_s"] = round(time.time() - t0, 2)
    _save(record, out_dir)
    return record


def _name(rec):
    return f"{rec['arch']}__{rec['shape']}__{rec['mesh']}".replace("/", "_")


def _save(rec, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    with open(f"{out_dir}/{_name(rec)}.json", "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="refused: the port compiles no program, so it has "
                         "no HLO")
    ap.add_argument("--no-correct", action="store_true",
                    help="accepted for JAX's command line; the port counts "
                         "every period directly and has no scan undercount "
                         "to correct")
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo: the port compiles no program, so there is no "
                 "HLO to save")

    from repro_torch.configs.registry import ARCHS
    from repro_torch.configs.shapes import SHAPES

    archs = sorted(ARCHS) if args.all or not args.arch else [args.arch]
    shapes = sorted(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = (["single_pod", "multi_pod"] if args.mesh == "both"
              else [args.mesh])

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"{arch} x {shape} x {mesh_kind}"
                print(f"=== dryrun {tag}", flush=True)
                try:
                    rec = run_cell(arch, shape, mesh_kind, args.out,
                                   correct=not args.no_correct)
                    print(f"=== done {tag}: {rec['status']} "
                          f"args={rec.get('argument_size_in_bytes')}B "
                          f"total={rec.get('total_s')}s", flush=True)
                except Exception as e:  # noqa: BLE001 — recorded per cell
                    traceback.print_exc()
                    failures.append(tag)
                    _save({"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": str(e)}, args.out)
    if failures:
        print("FAILURES:", failures)
        sys.exit(1)
    print("all cells ok")


if __name__ == "__main__":
    main()
