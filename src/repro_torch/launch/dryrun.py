"""The H100 planner: trace every (arch x shape) cell on the meta device
and count it, after ``repro.launch.dryrun`` (which lowers and compiles
each cell for a TPU pod).

No card and no kernel build is needed, and nothing is allocated:
parameters, optimizer state, caches and batches are meta tensors of the
port's dtypes (bf16 parameters, as the JAX planner takes them; AdamW's
m and v at :func:`opt_config`'s dtype; the cache leaves at
``models.cache_dtype``'s), and ``train_step``, ``prefill`` or
``decode_step`` runs on them under :class:`~repro_torch.utils.
op_analysis.OpAnalysis`, the counterpart of XLA's ``cost_analysis()``
and ``memory_analysis()``.  The kernel wrappers take their meta branch
(``kernels/ops.py``): each launch is counted with its roofline cost.

Per cell, three traces:

1. **memory**: the full-depth pass, training on one microbatch
   (``B / accum_steps`` rows) with ``accum_steps=1``; the gradient
   accumulator a step of ``accum_steps > 1`` holds beside it (the
   parameters' shape in the accumulation dtype) is added to its peak,
   and its kernels' launches are multiplied by ``accum_steps``.  (The
   accumulating step reads each microbatch's loss on the host, which a
   meta tensor cannot give, and the step is otherwise one microbatch's
   pass ``accum_steps`` times.)
2. **probe(1 stack)** and **probe(2 stacks)**: the pass at the cell's
   whole batch (``accum_steps=1``, as the JAX probes) at 1 and 2 layers
   (hybrid: superblocks); the totals extrapolate linearly in depth:
       total = probe1 + (n_stacks - 1) . (probe2 - probe1).
   Eager PyTorch unrolls every layer, so the rule is exact here (the
   JAX planner needs it because XLA counts a ``while`` body once); it
   keeps the cost of a deep cell's trace at two layers'.

A single card has no mesh: ``mesh`` is ``h100x1``, and the collective
term is zero.  ``--multi-pod`` and ``--serving-tp`` wait for tensor
parallelism (ROADMAP.md queue A item 13), and so do per-device terms on
a TP layout.  ``TRAIN_ACCUM`` is the reference's, part of each cell's
definition; it is not claimed to fit the card.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all [--skip-existing]
Artifacts: artifacts/dryrun_torch/<arch>__<shape>__h100x1.json (never
artifacts/dryrun/, the JAX planner's, whose records are a pod's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, ModelConfig,
                                 cells, get_config)
from repro_torch.models import (cache_dtype, cache_specs, decode_step,
                                model_specs, param_count, prefill)
from repro_torch.models.model import n_stacks
from repro_torch.models.quant import (QuantizedTensor, keeps_leading,
                                      quantizable)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainState, train_step
from repro_torch.utils import roofline as R
from repro_torch.utils.op_analysis import OpAnalysis

_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
ARTIFACT_DIR = os.path.normpath(os.path.join(_ROOT, "artifacts",
                                             "dryrun_torch"))
#: where the JAX planner writes (a pod's records); this one never does
REFERENCE_ARTIFACT_DIR = os.path.normpath(os.path.join(_ROOT, "artifacts",
                                                       "dryrun"))
MESH = "h100x1"
#: parameters in every cell, as the JAX planner takes them
PARAM_DTYPE = torch.bfloat16

#: >100B-param archs: bf16 optimizer state + bf16 grad accumulation
#: (the reference's memory compression, DESIGN.md §6).
BIG_ARCHS = {"mistral-large-123b", "jamba-1.5-large-398b", "arctic-480b",
             "grok-1-314b"}

#: Microbatch accumulation per arch for train_4k: the reference's, part of
#: each cell's definition (sized there for a TPU v5e pod's HBM).
TRAIN_ACCUM = {
    "musicgen-large": 8, "mistral-large-123b": 16, "starcoder2-7b": 16,
    "granite-3-2b": 16, "yi-9b": 16, "jamba-1.5-large-398b": 16,
    "arctic-480b": 16, "grok-1-314b": 16, "mamba2-130m": 4, "pixtral-12b": 16,
}

_TP_ITEM = ("tensor parallelism is not ported yet (ROADMAP.md queue A "
            "item 13): the H100 planner counts one card")


def opt_config(cfg: ModelConfig) -> AdamWConfig:
    dtype = torch.bfloat16 if cfg.name in BIG_ARCHS else torch.float32
    return AdamWConfig(state_dtype=dtype)


def _accum_dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.name in BIG_ARCHS else torch.float32


def probe_config(cfg: ModelConfig, stacks: int,
                 shape: InputShape) -> ModelConfig:
    """``cfg`` at ``stacks`` layers (hybrid: superblocks).  Unlike the JAX
    probes, the chunks stay the configuration's (``shape`` is unused):
    eager tracing has no compile time to save, and the scan's operations
    depend on its chunk, so the probes count the cell's own pass."""
    del shape
    per_stack = cfg.attn_period if cfg.family == "hybrid" else 1
    return dataclasses.replace(cfg, n_layers=stacks * per_stack)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_params(specs, dtype=PARAM_DTYPE, quant: bool = False):
    """Meta tensors of ``specs`` in ``dtype``; with ``quant`` every
    quantizable leaf int8 with its fp32 scales in the reference's layout
    (``abstract_quantized_params``)."""
    if isinstance(specs, dict):
        return {k: _meta_params(v, dtype, quant) for k, v in specs.items()}
    if quant and quantizable(specs):
        shape = specs.shape
        lead = shape[0] if keeps_leading(specs) else 1
        scale = (lead,) + (1,) * (len(shape) - 2) + (shape[-1],)
        return QuantizedTensor(_meta(shape, torch.int8),
                               _meta(scale, torch.float32))
    return _meta(specs.shape, dtype)


def batch_specs(cfg: ModelConfig, shape: InputShape,
                rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The cell's batch (``rows`` of it where given: a microbatch)."""
    B, S = rows or shape.global_batch, shape.seq_len
    if cfg.input_mode == "embeddings" and shape.kind != "decode":
        return {"embeds": _meta((B, S, cfg.d_model), PARAM_DTYPE),
                "labels": _meta((B, S), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32)}


def state_specs(cfg: ModelConfig, ocfg: AdamWConfig,
                dtype=PARAM_DTYPE) -> TrainState:
    """The train state on meta: parameters in ``dtype``, m and v at the
    optimizer's state dtype, the host's int32 step and count."""
    specs = model_specs(cfg)
    opt = {"m": _meta_params(specs, ocfg.state_dtype),
           "v": _meta_params(specs, ocfg.state_dtype),
           "count": torch.zeros((), dtype=torch.int32)}
    return TrainState(params=_meta_params(specs, dtype), opt=opt,
                      step=torch.zeros((), dtype=torch.int32))


def _cache(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    return {name: _meta(spec.shape, cache_dtype(cfg, name, PARAM_DTYPE))
            for name, spec in cache_specs(cfg, B, S).items()}


def input_specs(arch: str, shape_name: str, *, multi_pod: bool = False,
                cfg: Optional[ModelConfig] = None, quant: bool = False):
    """Meta stand-ins for every input of one (arch x shape) cell.

    train  -> (TrainState, batch)        for train_step
    prefill-> (params, batch)            for prefill
    decode -> (params, cache, tokens)    for decode_step
    """
    if multi_pod:
        raise NotImplementedError(_TP_ITEM)
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return state_specs(cfg, opt_config(cfg)), batch_specs(cfg, shape)
    params = _meta_params(model_specs(cfg), quant=quant)
    if shape.kind == "prefill":
        return params, batch_specs(cfg, shape)
    return params, _cache(cfg, shape), _meta((shape.global_batch, 1),
                                             torch.int32)


def arguments(arch: str, shape_name: str, *,
              cfg: Optional[ModelConfig] = None,
              quant: bool = False) -> OpAnalysis:
    """The cell's inputs (:func:`input_specs`, the whole batch) registered
    as a pass's: ``.argument_bytes`` is the record's (the host's step and
    AdamW count, 0-dim, are not device bytes)."""
    return OpAnalysis().arguments(*input_specs(arch, shape_name, cfg=cfg,
                                               quant=quant))


def trace_cell(cfg: ModelConfig, shape: InputShape, *, rows: Optional[int]
               = None, quant: bool = False, memory: bool = True,
               dtype=PARAM_DTYPE, ocfg: Optional[AdamWConfig] = None
               ) -> OpAnalysis:
    """One pass of the cell on meta tensors under an :class:`OpAnalysis`:
    a training step with ``accum_steps=1`` on ``rows`` rows (the whole
    batch by default; parameters in ``dtype``, the optimizer ``ocfg``,
    :func:`opt_config`'s by default), a prefill of the whole batch, or
    one decode step over a full cache."""
    a = OpAnalysis(memory=memory)
    if shape.kind == "train":
        ocfg = ocfg or opt_config(cfg)
        state = state_specs(cfg, ocfg, dtype)
        batch = batch_specs(cfg, shape, rows)
        with a:
            a.arguments(state, batch)
            out = train_step(cfg, state, batch, opt_cfg=ocfg)
            a.outputs(out)
        return a
    params = _meta_params(model_specs(cfg), quant=quant)
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)
        with a:
            a.arguments(params, batch)
            out = prefill(cfg, params, batch, max_seq=shape.seq_len)
            a.outputs(out)
        return a
    if shape.kind == "decode":
        cache = _cache(cfg, shape)
        tok = _meta((shape.global_batch, 1), torch.int32)
        with a:
            a.arguments(params, cache, tok)
            out = decode_step(cfg, params, cache, tok)
            a.outputs(out)
        return a
    raise ValueError(shape.kind)


def _extrapolate(p1: Dict, p2: Dict, stacks: int,
                 p3: Optional[Dict] = None) -> Dict[str, Any]:
    """The JAX planner's rule, ``p1 + (stacks - 1) . (p2 - p1)``; with a
    third probe also its second difference, ``+ (stacks - 1)(stacks - 2)
    / 2 . (p3 - 2 p2 + p1)``: exact for counts quadratic in depth (a
    training step's bytes, :func:`probe_record`)."""
    def ext(key, sub=None):
        def get(p):
            return (p[key] if sub is None else p[key].get(sub, 0.0))
        a, b = get(p1), get(p2)
        out = a + (stacks - 1) * max(b - a, 0.0)
        if p3 is not None:
            out += (stacks - 1) * (stacks - 2) / 2 * (get(p3) - 2 * b + a)
        return out

    rates = set(p1["flops_by_rate"]) | set(p2["flops_by_rate"])
    return {
        "flops": ext("flops"),
        "work": ext("work"),
        "flops_by_rate": {r: ext("flops_by_rate", r) for r in rates},
        "bytes": ext("bytes"),
        "coll": {k: ext("coll", k) for k in p1["coll"]},
    }


def probe_record(cfg: ModelConfig, shape: InputShape,
                 quant: bool = False) -> Dict[str, Any]:
    """The record's cost keys from the probes: the extrapolated
    operations (``cost.flops_per_device`` plain; ``flops_by_rate`` in the
    rates' units), bytes and collective bytes, the roofline on one card,
    and the useful-FLOPs ratio against ``model_flops``.

    A training step's bytes grow with the square of the depth: the
    backward of layer ``i``'s view of a stacked leaf writes a zeroed
    gradient of the whole stack, and the stack's gradient sums one a
    layer (ROADMAP.md A14's stacked leaves).  So a training cell takes a
    third probe (``probe3``) and the rule's second difference."""
    stacks = n_stacks(cfg)
    depths = (1, 2, 3) if shape.kind == "train" else (1, 2)
    costs = {k: trace_cell(probe_config(cfg, k, shape), shape, quant=quant,
                           memory=False).costs() for k in depths}
    total = _extrapolate(costs[1], costs[2], stacks, costs.get(3))
    terms = R.roofline(total["flops_by_rate"], total["bytes"],
                       total["coll"]["total"])
    mflops_dev = R.model_flops(cfg, shape)
    extra = {"probe3": costs[3]} if 3 in costs else {}
    return {
        "probe1": costs[1], "probe2": costs[2], **extra, "stacks": stacks,
        "cost": {"flops_per_device": total["work"],
                 "bytes_per_device": total["bytes"],
                 "flops_by_rate": total["flops_by_rate"]},
        "collectives": total["coll"],
        "roofline": dict(terms.as_dict(), bound_s=terms.bound_time_s),
        "model_flops_per_device": mflops_dev,
        "useful_flops_ratio": (mflops_dev / total["work"])
                              if total["work"] else None,
    }


def device_memory_bytes() -> int:
    """The card's memory where one is present, else an H100 80GB
    HBM3's."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return R.H100_MEMORY_BYTES


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = ARTIFACT_DIR, verbose: bool = True,
             variant: str = "", quant: bool = False,
             accum: Optional[int] = None,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             probes: bool = True,
             serving_tp: Optional[int] = None) -> Dict[str, Any]:
    if multi_pod or serving_tp is not None:
        raise NotImplementedError(_TP_ITEM)
    _check_out_dir(out_dir)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{variant}" if variant else ""
    out_path = os.path.join(out_dir,
                            f"{arch}__{shape_name}__{MESH}{suffix}.json")
    if accum is None:
        accum = TRAIN_ACCUM[arch] if shape.kind == "train" else 1
    if shape.kind == "train" and shape.global_batch % accum:
        raise ValueError(f"batch {shape.global_batch} is not whole "
                         f"microbatches of {accum}")
    rows = shape.global_batch // accum if shape.kind == "train" else None

    # ---- 1. the full-depth pass: memory and launches ------------------------
    t0 = time.time()
    full = trace_cell(cfg, shape, rows=rows, quant=quant)
    t_trace = time.time() - t0
    mem = full.memory_analysis()
    # the step's inputs hold the whole batch (its microbatches are views)
    args = arguments(arch, shape_name, cfg=cfg, quant=quant)
    mem["peak_device_bytes"] += args.argument_blocks - full.argument_blocks
    mem["argument_bytes"] = args.argument_bytes
    accum_bytes = 0
    if shape.kind == "train" and accum > 1:
        size = torch.empty((), dtype=_accum_dtype(cfg)).element_size()
        accum_bytes = param_count(model_specs(cfg)) * size
    mem["accum_bytes"] = accum_bytes
    mem["peak_device_bytes"] += accum_bytes
    mem["temp_bytes"] += accum_bytes
    capacity = device_memory_bytes()
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": MESH, "chips": 1,
        "kind": shape.kind, "accum_steps": accum, "variant": variant,
        "rule_overrides": None, "quant": quant,
        "params_total": param_count(model_specs(cfg)),
        "params_active": int(R.active_params(cfg)),
        "trace_s": round(t_trace, 1),
        "memory": mem,
        "device_memory_bytes": capacity,
        "fits": mem["peak_device_bytes"] <= capacity,
        "kernels": {name: k["launches"] * accum
                    for name, k in full.kernel_summary().items()},
    }
    del full

    # ---- 2. cost probes: the roofline -----------------------------------------
    if probes:
        record.update(probe_record(cfg, shape, quant=quant))
    record["total_s"] = round(time.time() - t0, 1)

    with open(out_path, "w") as f:
        json.dump(record, f, indent=2)
    if verbose:
        print(summary_line(record), flush=True)
    return record


def summary_line(record: Dict[str, Any]) -> str:
    """One cell on one line: whether it fits, its peak, and (with
    probes) its FLOPs, bytes, dominant term and bound."""
    msg = (f"[dryrun] {record['arch']} x {record['shape']} x "
           f"{record['mesh']}: fits={record['fits']}, peak "
           f"{record['memory']['peak_device_bytes'] / 2 ** 30:.2f} GiB")
    if "roofline" in record:
        r = record["roofline"]
        msg += (f", flops {record['cost']['flops_per_device']:.3e}"
                f", bytes {r['bytes_per_chip']:.3e}"
                f", dominant={r['dominant']}"
                f", bound {r['bound_s'] * 1e3:.3f} ms"
                f", useful={round(record['useful_flops_ratio'], 3)}")
    return msg + f" ({record['total_s']} s)"


def _check_out_dir(out_dir: str) -> None:
    if os.path.normpath(os.path.abspath(out_dir)) == os.path.abspath(
            REFERENCE_ARTIFACT_DIR):
        raise ValueError(f"{out_dir} holds the JAX planner's records (a "
                         "pod's); the H100 planner writes under "
                         f"{ARTIFACT_DIR}")


def run_all(out_dir: str = ARTIFACT_DIR, skip_existing: bool = False,
            verbose: bool = True) -> list:
    """Every (arch x shape) cell; returns the failures as ``(arch, shape,
    error)``."""
    failures = []
    for arch in ARCH_IDS:
        for shape in cells(arch):
            out_path = os.path.join(out_dir,
                                    f"{arch}__{shape.name}__{MESH}.json")
            if skip_existing and os.path.exists(out_path):
                print(f"[dryrun] skip existing {out_path}", flush=True)
                continue
            try:
                run_cell(arch, shape.name, out_dir=out_dir, verbose=verbose)
            except Exception as e:
                traceback.print_exc()
                failures.append((arch, shape.name, repr(e)))
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: needs tensor parallelism (queue A item "
                         "13)")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=ARTIFACT_DIR)
    ap.add_argument("--variant", default="", help="artifact name suffix")
    ap.add_argument("--quant", action="store_true",
                    help="int8 weight-only params (serving cells)")
    ap.add_argument("--serving-tp", type=int, default=None,
                    help="refused: needs tensor parallelism (queue A item "
                         "13)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--no-probes", action="store_true",
                    help="the full-depth trace only (memory iterations)")
    ap.add_argument("--cfg", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="ModelConfig override, e.g. remat=slot ssm_chunk=128")
    args = ap.parse_args(argv)
    if args.multi_pod or args.serving_tp is not None:
        ap.error(_TP_ITEM)
    _check_out_dir(args.out_dir)

    cfg_overrides: Dict[str, Any] = {}
    for cv in args.cfg:
        k, v = cv.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            try:
                v = float(v)
            except ValueError:
                pass
        cfg_overrides[k] = v
    cfg_overrides = cfg_overrides or None

    if args.all:
        t0 = time.time()
        failures = run_all(args.out_dir, args.skip_existing)
        if failures:
            print(f"[dryrun] FAILURES ({len(failures)}):")
            for f in failures:
                print("  ", f)
            raise SystemExit(1)
        print(f"[dryrun] all cells traced OK in {time.time() - t0:.1f} s")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    run_cell(args.arch, args.shape, out_dir=args.out_dir,
             variant=args.variant, quant=args.quant, accum=args.accum,
             cfg_overrides=cfg_overrides, probes=not args.no_probes)


if __name__ == "__main__":
    main()
