"""Where a solve's time goes on the card: device busy share and kernel times.

  python -m repro_torch.launch.profile --problem synth:atmosmod \
      --n 1270432 --formats float64,frsz2_32 --driver device

For each format: one warm-up solve (with ``--driver device`` it captures the
cycle's CUDA graph), then one solve under ``torch.profiler``
(CPU + CUDA activities).  Prints the wall time (host clock around work that
ends in a synchronize), the summed device time of all kernels, their ratio
(the device busy share; the rest is the card waiting on the host), beside
it the program's own spans of the profiled solve by name (``spans``: count,
total and self milliseconds, :mod:`repro_torch.tracing`) and the counters
that moved in it (``counters``: graph captures, cache hits, steps run and
live, ``launches.<kernel>``), and the kernels that took the most device
time, as JSON lines.  ``--batch k``
profiles a solve of k right-hand sides (``_batch_rhs``) through
``gmres_batched`` with ``--method block`` or ``vmap``.

``--arch yi-9b`` (or any served architecture: the dense, MoE, SSM,
hybrid, encoder-decoder and VLM families) profiles LM decode steps instead,
at ``chip_smoke.py``'s
serving shape (8 slots, prompt 2048, random weights from seed 0;
``profile_decode`` takes other slots and prompt lengths, as
``chip_smoke.py`` phase 10 calls it for mixtral at 8 layers), once per
KV format in ``--formats`` (e.g. ``frsz2_16,bf16``): a warm-up prefill, one
prefill under the profiler, two warm-up steps, then four steps under the
profiler, each starting with the host read of the previous step's tokens, as
in ``serve``.  Besides the busy share it reports the kernel launches per
step, the prefill's wall, device time and launches, and the step's byte
bound (``decode_step_bytes``).  For an FRSZ2 format of a model with a KV
cache it also times one layer's KV-cache write (``time_cache_write``).
Needs a CUDA card.

``--train [--arch yi-9b]`` profiles a training step instead, at phase
13's shape (the model cut to 8 layers at full width, FRSZ2-coded AdamW
moments, batch 4 in one microbatch, ``train_4k``'s S 4,096)
(``profile_train``): a warm-up step, then one step of ``launch.train``'s
``make_step`` (the loss, its backward and the AdamW update) under the
profiler, its wall, device time, busy share and launches, tokens a second,
the model FLOPs utilisation of a dense model (``train_step_flops``), and
the AdamW update alone: its device time by CUDA events and under the
profiler, its launches and the time of its codec kernels against the bytes
those must move (``opt_update_bytes``).

The module uses only the port's public entry points (the model, the
profiler, ``kvcache``), so a copy of it placed in an older checkout's
``src/repro_torch/launch`` times that port alike.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.launch.solve import _batch_rhs
from repro_torch.models import SHAPES, decode_step, init_params, kvcache, prefill
from repro_torch.launch.serve import aux_for
from repro_torch.models.lm import (cross_layers, cross_len, init_decode_cache,
                                   kv_layers)
from repro_torch.roofline.analysis import HW_H100
from repro_torch.solver import gmres, gmres_batched
from repro_torch.sparse import make_problem, rhs_for

#: the serving shape of ``chip_smoke.py`` phase 9
SERVE_SLOTS, SERVE_PROMPT, SERVE_STEPS = 8, 2048, 4
#: the training shape of phase 13 (its sequence is ``train_4k``'s): full
#: width at 8 layers, which fits the card with the coded moments (48 do not)
TRAIN_BATCH, TRAIN_LAYERS = 4, 8
#: H100 SXM data sheet: HBM3 at 3.35 TB/s; dense bf16 tensor-core peak
HBM_BYTES_PER_S = HW_H100["hbm_bw"]
BF16_FLOPS = HW_H100["peak_flops"]


def _nbytes(tree) -> int:
    return sum(_nbytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def _unread_in_decode(cfg, params) -> int:
    """Bytes of weights a decode step never reads: the encoder (it ran in
    the prefill) and the cross blocks' ``wk``/``wv`` (their K/V are in the
    cross caches)."""
    if cfg.family == "encdec":
        cross = params["layers"]["cross"]
    elif cfg.family == "vlm":
        cross = params["cross_layers"]["attn"]
    else:
        return 0
    return (_nbytes(params.get("encoder", {}))
            + _nbytes({k: cross[k] for k in ("wk", "wv")}))


def decode_step_bytes(cfg, params, slots: int, mean_len: float) -> dict:
    """The bytes a decode step of ``slots`` rows must move, and the least
    time they take at the card's memory rate (``bound_ms``):

    * ``weight_bytes``: every weight a step reads once: all but the
      embedding table (a step gathers ``slots`` rows of it), the encoder
      and the cross blocks' ``wk``/``wv`` (never read in decode); the MoE
      experts all (``moe_block`` reads every expert), and the hybrid's
      shared attention and MLP block once an application: at 0.41 GB
      (zamba2-7b) it does not stay in the 50 MB L2 from one application to
      the next;
    * ``state_bytes``: the SSM families' ``ssm_h`` and ``ssm_conv`` read
      and written;
    * ``cache_bytes``: the self-attention K/V positions attended,
      ``mean_len`` a row, in every layer of ``kv_layers``, at the cache
      format's bits a value;
    * ``cross_bytes``: every cross cache (``cross_layers``) read whole, at
      its ``cross_len`` source positions a row.
    """
    weights = (_nbytes(params) - _nbytes({"embed": params["embed"]})
               - _unread_in_decode(cfg, params))
    R = kv_layers(cfg)
    if cfg.family == "hybrid":
        weights += (R - 1) * _nbytes({k: params[k] for k in
                                      ("shared_attn", "shared_mlp")})
    state = 0
    if cfg.family in ("ssm", "hybrid"):
        st = init_decode_cache(cfg, slots, 1, device="meta")
        state = 2 * _nbytes({k: st[k] for k in ("ssm_h", "ssm_conv")})
    fmt = kvcache.cache_format(cfg.kv_format)
    # a position of every row, K and V, in one layer
    per_pos = (slots * cfg.num_kv_heads * 2 * cfg.hd
               * fmt.bits_per_value(cfg.hd) / 8)
    cache = R * mean_len * per_pos
    cross = cross_layers(cfg) * cross_len(cfg) * per_pos
    return dict(weight_bytes=weights, state_bytes=state, cache_bytes=cache,
                cross_bytes=cross,
                bound_ms=(weights + state + cache + cross)
                / HBM_BYTES_PER_S * 1e3)


def profile_solve(A, b, fmt: str, *, m: int, max_iters: int, target: float,
                  driver: str = "device", batch: int = 1,
                  method: str = "vmap", top: int = 10) -> dict:
    from torch.profiler import ProfilerActivity, profile

    kw = dict(storage=fmt, m=m, max_iters=max_iters, target_rrn=target,
              driver=driver)
    if batch > 1:
        B = _batch_rhs(b, batch)

        def solve():
            return gmres_batched(A, B, method=method, **kw)
    else:
        def solve():
            return [gmres(A, b, **kw)]
    try:
        from repro_torch import tracing
    except ImportError:             # an older port, without the tracer
        tracing = None
    solve()                                         # warm-up: builds, caches
    torch.cuda.synchronize()
    if tracing is not None:
        rows0, counts0 = len(tracing.rows()), tracing.counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        results = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    program = {}
    if tracing is not None:
        program = dict(
            spans=tracing.summary(tracing.rows()[rows0:]),
            counters={k: v - counts0[k]
                      for k, v in tracing.counters().items()
                      if v != counts0[k]})
    kernels = _device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    iters = sum(r.iterations for r in results)
    return dict(format=fmt, driver=driver, batch=batch,
                method=method if batch > 1 else None, n=A.shape[0],
                iters=iters, wall_s=wall, device_s=device_us * 1e-6,
                device_busy_share=device_us * 1e-6 / wall,
                wall_per_iter_ms=wall * 1e3 / max(iters, 1), **program,
                top=[dict(name=e.key[:100], calls=e.count,
                          device_ms=e.self_device_time_total * 1e-3)
                     for e in kernels])


def _device_kernels(prof):
    """The events that ran on the card (the host ops that launched them
    report the same device time again, so they are left out)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _event_ms(fn, reps: int = 30) -> float:
    """Median device time of ``fn`` by CUDA events, after one warm call.
    The card first sleeps ~1 ms, so that the host has queued all of
    ``fn``'s launches before the first event fires: the events then time
    the card's work, not the host's launching."""
    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_ms(fn, reps: int) -> float:
    """Host time a call over ``reps`` back-to-back calls (what a host-bound
    step pays), after three warm calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def time_cache_write(cfg) -> dict:
    """One layer's KV-cache write at the serving shape, on seeded bf16 K/V:
    ``kvcache.append`` of a decode step (B, 1, Hkv, D) at lengths
    ``SERVE_PROMPT`` and ``kvcache.build_cache`` of the prefill (B,
    SERVE_PROMPT, Hkv, D), by CUDA events and by the host clock."""
    fmt = kvcache.cache_format(cfg.kv_format)
    B, Hkv, D, S = SERVE_SLOTS, cfg.num_kv_heads, cfg.hd, SERVE_PROMPT + 72
    gen = torch.Generator(device="cuda").manual_seed(11)

    def kv(T):
        return [torch.randn((B, T, Hkv, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2)]

    (k1, v1), (kp, vp) = kv(1), kv(SERVE_PROMPT)
    lengths = torch.full((B,), SERVE_PROMPT, dtype=torch.int32, device="cuda")
    lc = {n: t[0] for n, t in kvcache.init_cache(fmt, 1, B, Hkv, S, D,
                                                 device="cuda").items()}

    def step():
        kvcache.append(lc, k1, v1, lengths, fmt)

    def build():
        kvcache.build_cache(kp, vp, fmt, cache_len=S, out=lc)

    tiny = torch.zeros(1, device="cuda")
    return dict(floor_ms=_event_ms(tiny.zero_), step_ms=_event_ms(step),
                step_host_ms=_host_ms(step, 200), prefill_ms=_event_ms(build),
                prefill_host_ms=_host_ms(build, 20))


def profile_decode(cfg, params, *, top: int = 10, slots: int = SERVE_SLOTS,
                   prompt_len: int = SERVE_PROMPT, steps: int = SERVE_STEPS,
                   profile_prefill: bool = True, aux_inputs=None) -> dict:
    """``steps`` decode steps (and, with ``profile_prefill``, the prefill)
    under the profiler.  The profiler's own cost grows with the kernels it
    records: a full-depth SSM prefill launches ~10^5 of them
    (falcon-mamba-7b's scan: one a position and layer), which takes it
    minutes to process, so ``profile_prefill=False`` runs the prefill
    unprofiled and reports only its wall.  ``aux_inputs``: the encdec and
    VLM families' frames or image embeddings for the prefill (by default
    ``serve.aux_for`` drawn from seed 0)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (slots, prompt_len),
                           generator=gen, device="cuda")
    if aux_inputs is None:
        aux_inputs = aux_for(cfg, slots, gen)
    cache_len = prompt_len + steps + 2
    if profile_prefill:
        prefill(params, cfg, prompt, aux_inputs, cache_len=cache_len)
    torch.cuda.synchronize()
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if profile_prefill else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, prompt, aux_inputs,
                                cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_wall = time.perf_counter() - t0
    pre = dict(prefill_wall_ms=prefill_wall * 1e3)
    if profile_prefill:
        kernels = _device_kernels(prof)
        pre.update(prefill_device_ms=sum(e.self_device_time_total
                                         for e in kernels) * 1e-3,
                   prefill_launches=sum(e.count for e in kernels))

    def step(tokens, cache):                        # as serve's loop
        tokens.tolist()
        logits, cache = decode_step(params, cfg, cache, tokens)
        return logits.argmax(-1), cache

    tokens = logits.argmax(-1)
    for _ in range(2):
        tokens, cache = step(tokens, cache)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tokens, cache = step(tokens, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    n = steps
    # the profiled steps attend prompt + 3 .. prompt + 2 + steps positions
    bound = decode_step_bytes(cfg, params, slots, prompt_len + 2.5 + n / 2)
    return dict(arch=cfg.name, kv_format=cfg.kv_format, slots=slots,
                prompt=prompt_len, steps=n, wall_per_step_ms=wall * 1e3 / n,
                device_per_step_ms=device_us * 1e-3 / n,
                device_busy_share=device_us * 1e-6 / wall,
                launches_per_step=sum(e.count for e in _device_kernels(prof))
                / n,
                top=[dict(name=e.key[:100], calls_per_step=e.count / n,
                          device_ms_per_step=e.self_device_time_total
                          * 1e-3 / n) for e in kernels],
                step_bound_ms=bound.pop("bound_ms"),
                **{f"step_{k}": v for k, v in bound.items()}, **pre)


def train_step_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one training step of a dense model: 6 per token and
    matrix weight (the layers' and the unembedding's; forward and
    backward), plus causal attention's two S x S products, forward and
    backward (3 x 4 x B x S^2 x H x hd / 2 a layer).  Recomputation under
    remat is not model work and is not counted."""
    if cfg.family != "dense":
        raise ValueError(f"model FLOPs are counted for the dense family, "
                         f"not {cfg.family} ({cfg.name})")
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    per_layer = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * cfg.d_ff
    matmul = cfg.num_layers * per_layer + d * cfg.vocab_size
    attn = 3 * cfg.num_layers * 4 * batch * seq * seq * H * hd / 2
    return 6.0 * matmul * batch * seq + attn


def opt_update_bytes(opt_state) -> int:
    """Bytes the codec kernels of one coded AdamW update must move: for m
    and v of every leaf, the decode (codes and exponents read, f32 values
    written) and the code (f32 read, codes and exponents written)."""
    from repro_torch.core.frsz2 import BlockCompressed
    from repro_torch.tree import tree_leaves

    total = 0
    for part in ("m", "v"):
        for bc in tree_leaves(opt_state[part]):
            if not isinstance(bc, BlockCompressed):
                continue
            coded = (bc.codes.numel() * bc.codes.element_size()
                     + bc.exps.numel() * bc.exps.element_size())
            total += 2 * (coded + bc.n * 4)
    return total


def profile_train(cfg, opt, *, batch: int, seq: int, params=None, opt_state=None, top: int = 10,
                  reps: int = 5, warmup: bool = True) -> dict:
    """One training step under the profiler, after a warm-up step (none
    with ``warmup=False``, where the caller has trained already), and the
    AdamW update alone (``reps`` timed calls on the step's gradients).
    ``params`` and ``opt_state`` (on the card) default to random weights
    from seed 0 and a fresh state."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import GlobalBatchSpec
    from repro_torch.launch.train import (TrainConfig, _stub_embeds,
                                          make_step, value_and_grad)
    from repro_torch.optim import adamw_init, adamw_update

    dev = torch.device("cuda")
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    if opt_state is None:
        opt_state = adamw_init(params, opt)
    tc = TrainConfig(global_batch=batch, seq_len=seq, microbatch=1)
    data = GlobalBatchSpec(seed=0, seq_len=seq, global_batch=batch,
                           vocab=cfg.vocab_size)
    step_fn = make_step(cfg, opt, tc)

    def batch_at(step):
        b = {"tokens": torch.from_numpy(data.global_batch_at(step)).to(dev)}
        if cfg.family in ("encdec", "vlm"):
            key = "frames" if cfg.family == "encdec" else "image_embeds"
            n = cross_len(cfg)
            b[key] = _stub_embeds(cfg, tc, step, n, dev)
        return b

    if warmup:
        params, opt_state, _ = step_fn(params, opt_state, batch_at(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    b1 = batch_at(1)
    # the card's kernels only: the host's op events are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, stats = step_fn(params, opt_state, b1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    kernels = _device_kernels(prof)
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    topk = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    tokens = batch * seq
    row = dict(arch=cfg.name, layers=cfg.num_layers, batch=batch, seq=seq,
               microbatch=1, compress_state=opt.compress_state,
               loss=float(stats["loss"]), step_wall_ms=wall * 1e3,
               step_device_ms=device_us * 1e-3,
               device_busy_share=device_us * 1e-6 / wall,
               step_launches=launches, tokens_per_s=tokens / wall,
               peak_mem_bytes=peak,
               top=[dict(name=e.key[:100], calls=e.count,
                         device_ms=e.self_device_time_total * 1e-3)
                    for e in topk])
    if cfg.family == "dense":
        flops = train_step_flops(cfg, batch, seq)
        row.update(model_flops=flops, mfu=flops / (wall * BF16_FLOPS),
                   flops_bound_ms=flops / BF16_FLOPS * 1e3)

    # the AdamW update alone, on this step's gradients
    _, grads = value_and_grad(params, cfg, b1)

    def update():
        return adamw_update(grads, opt_state, params, opt)

    row["update_ms"] = _event_ms(update, reps=reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        update()
        torch.cuda.synchronize()
    kernels = _device_kernels(prof)
    codec = [e for e in kernels if "compress_kernel" in e.key]
    row.update(update_device_ms=sum(e.self_device_time_total
                                    for e in kernels) * 1e-3,
               update_launches=sum(e.count for e in kernels),
               update_codec_ms=sum(e.self_device_time_total
                                   for e in codec) * 1e-3,
               update_codec_launches=sum(e.count for e in codec))
    if opt.compress_state:
        nbytes = opt_update_bytes(opt_state)
        row.update(update_codec_bytes=nbytes,
                   update_codec_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", default="synth:atmosmod")
    ap.add_argument("--n", type=int, default=1270432)
    ap.add_argument("--formats", default="float64,frsz2_32")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--max-iters", type=int, default=500)
    ap.add_argument("--driver", default="device",
                    help="restart loop(s), comma-separated: device, host")
    ap.add_argument("--batch", type=int, default=1,
                    help="right-hand sides per solve")
    ap.add_argument("--method", default="vmap",
                    help="batched method(s), comma-separated: vmap, block")
    ap.add_argument("--arch", default=None,
                    help="profile this model's decode steps instead of a "
                         "solve; --formats then names KV formats")
    ap.add_argument("--top", type=int, default=10,
                    help="kernels listed, the most device time first")
    ap.add_argument("--train", action="store_true",
                    help="profile a training step of --arch (yi-9b) at "
                         f"{TRAIN_LAYERS} layers, coded moments, instead")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    if args.train:
        import dataclasses

        from repro_torch.optim import AdamWConfig

        cfg = dataclasses.replace(get_arch(args.arch or "yi-9b"),
                                  num_layers=TRAIN_LAYERS)
        opt = AdamWConfig(compress_state=True)
        print(json.dumps(profile_train(
            cfg, opt, batch=TRAIN_BATCH, seq=SHAPES["train_4k"].seq_len,
            top=args.top)), flush=True)
        return
    if args.arch:
        import dataclasses

        cfg = get_arch(args.arch)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
        for fmt in args.formats.split(","):
            cfg_f = dataclasses.replace(cfg, kv_format=fmt)
            row = profile_decode(cfg_f, params, top=args.top)
            if kvcache.cache_format(fmt).kind == "frsz2" and kv_layers(cfg):
                row["cache_write"] = time_cache_write(cfg_f)
            print(json.dumps(row), flush=True)
        return
    A, target = make_problem(args.problem, args.n, device=dev)
    b, _ = rhs_for(A, device=dev)
    methods = args.method.split(",") if args.batch > 1 else ["vmap"]
    for method in methods:
        for driver in args.driver.split(","):
            for fmt in args.formats.split(","):
                print(json.dumps(profile_solve(
                    A, b, fmt, m=args.m, max_iters=args.max_iters,
                    target=target, driver=driver, batch=args.batch,
                    method=method, top=args.top)), flush=True)


if __name__ == "__main__":
    main()
