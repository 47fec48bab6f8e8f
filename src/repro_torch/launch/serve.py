"""Serving launcher: synthetic traffic through the batching scheduler, the
port of the JAX package's ``repro.launch.serve``.

Drives ``serving.scheduler.Scheduler`` with a seeded Poisson arrival
process: request arrivals, prompt lengths, prompt tokens, generation
lengths and an audio model's frame embeddings are all drawn from one
``numpy`` generator, in the JAX launcher's order, and time is measured in
*scheduler steps*, so a given ``--seed`` always produces the same
admission trace and (greedy decode being deterministic) the same tokens.  Runs on the CUDA card unless asked for
the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --smoke \\
        --requests 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --no-smoke --arch h2o-danube-1.8b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --no-smoke --arch kimi-k2-1t-a32b --n-layers 2

``--batch`` switches to the one-shot mode (a single ``Engine.generate``
call over a fixed batch).  The initial weights are
``transformer.init_params`` drawn from a ``torch.Generator`` seeded with
``--seed`` on the device, in the config's ``param_dtype``.  ``--n-layers``
serves the config at that depth (0 keeps the config's), as the trainer's
flag does: kimi-k2-1t-a32b's 61 layers (1.03 T parameters) do not fit one
card, its first two (one dense, one MoE) do.
"""
import argparse
from typing import Any, Callable, Dict, List, Optional, Tuple


def traffic(vocab: int, n_requests: int, rate: float,
            prompt_len_range=(4, 12), new_tokens_range=(3, 8),
            seed: int = 0, frames_shape: Optional[Tuple[int, int]] = None
            ) -> List[List[tuple]]:
    """The seeded arrival trace: for each round of the launcher's loop,
    the list of requests that arrive in it (``Poisson(rate)`` a round,
    capped at ``n_requests`` in all), each the arguments of
    ``Scheduler.submit``: ``(prompt, max_new)``, or with ``frames_shape``
    (an audio model's ``(n_frames, d_model)``) ``(prompt, max_new,
    frames)``, the frames drawn from the same generator after the prompt,
    as the JAX launcher draws them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rounds, n = [], 0
    while n < n_requests:
        arrivals = []
        for _ in range(int(rng.poisson(rate))):
            if n >= n_requests:
                break
            plen = int(rng.integers(*prompt_len_range, endpoint=True))
            n_new = int(rng.integers(*new_tokens_range, endpoint=True))
            prompt = rng.integers(1, vocab, plen).astype(np.int32)
            if frames_shape is None:
                arrivals.append((prompt, n_new))
            else:
                arrivals.append((prompt, n_new, rng.normal(
                    size=frames_shape).astype(np.float32)))
            n += 1
        rounds.append(arrivals)
    return rounds


def frames_shape(cfg) -> Optional[Tuple[int, int]]:
    """An audio model's per-request frames, ``(n_frames, d_model)``; None
    for a model without them."""
    return (cfg.n_frames, cfg.d_model) if cfg.family == "audio" else None


def load_model(arch: str, smoke: bool, seed: int, device=None,
               param_dtype: str = "",
               init_fn: Optional[Callable[[int], dict]] = None,
               n_layers: int = 0):
    """``(cfg, params)`` on ``device``: the port's own draw from a
    generator seeded with ``seed``, or ``init_fn(seed)`` (a tree of numpy
    arrays, for example the JAX package's initial weights, or of tensors,
    which are moved to ``device``).  ``param_dtype`` sets the param and
    compute dtype ("" keeps the config's); ``n_layers`` the depth (0 keeps
    the config's): the config at that depth is drawn, nothing more."""
    import numpy as np
    import torch
    from repro_torch import tree as TR
    from repro_torch.configs import registry as REG
    from repro_torch.convert import params_from_numpy
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T

    dev = resolve_device(device)
    cfg = REG.get_smoke_config(arch) if smoke else REG.get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if param_dtype:
        cfg = cfg.replace(param_dtype=param_dtype, compute_dtype=param_dtype)
    if init_fn is not None:
        params = init_fn(seed)
        if isinstance(TR.leaves(params)[0], np.ndarray):
            return cfg, params_from_numpy(params, dev)
        return cfg, TR.tree_map(lambda t: t.to(dev), params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, T.init_params(gen, cfg, device=dev)


def run_traffic(arch: str = "mamba2-780m", smoke: bool = True,
                n_requests: int = 8, rate: float = 0.7,
                prompt_len_range=(4, 12), new_tokens_range=(3, 8),
                max_slots: int = 4, prefill_chunk: int = 8,
                token_budget: int = 32, max_len: int = 64,
                seed: int = 0, metrics_out: Optional[str] = None,
                quiet: bool = False, profile_dir: str = "",
                profile_start: int = 0, profile_stop: int = 4,
                spans_out: str = "", device=None,
                window_override: Optional[int] = None,
                param_dtype: str = "",
                init_fn: Optional[Callable[[int], dict]] = None,
                n_layers: int = 0) -> Dict[str, Any]:
    """Seeded Poisson-arrival workload; returns a summary dict, with every
    request's tokens under ``"tokens"`` (in submission order).

    Per driver round, ``Poisson(rate)`` new requests arrive (capped at
    ``n_requests`` total); then the scheduler takes one step if it has
    work.  ``metrics_out`` captures the ``serve.step`` / ``serve.request``
    telemetry stream as JSONL (``python -m repro_torch.obs.report``
    renders the per-phase breakdown).  ``profile_dir`` captures a
    ``torch.profiler`` trace over scheduler steps ``[profile_start,
    profile_stop]``; ``spans_out`` writes the host-side phase spans as a
    Perfetto-loadable Chrome trace.  The arguments are the JAX launcher's,
    plus ``device`` (``cuda`` by default, which raises without a card),
    ``window_override``, ``param_dtype``, ``init_fn`` and ``n_layers``
    (see :func:`load_model`).
    """
    import numpy as np
    from repro_torch import obs
    from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

    cfg, params = load_model(arch, smoke, seed, device, param_dtype, init_fn,
                             n_layers)
    sink = obs.JsonlSink(metrics_out) if metrics_out else obs.MemorySink()
    sch = Scheduler(cfg, params,
                    SchedulerConfig(max_slots=max_slots, max_len=max_len,
                                    prefill_chunk=prefill_chunk,
                                    token_budget=token_budget,
                                    window_override=window_override),
                    sink=sink)
    rounds = traffic(cfg.vocab, n_requests, rate, prompt_len_range,
                     new_tokens_range, seed, frames_shape(cfg))
    rids = []
    max_occ = 0
    max_queue = 0
    prof = obs.ProfileWindow(profile_dir or None, profile_start,
                             profile_stop)
    recorder = obs.SpanRecorder() if spans_out else None
    prev = obs.set_recorder(recorder) if recorder is not None else None
    try:
        i = 0
        while i < len(rounds) or sch.has_work:
            if i < len(rounds):
                rids += [sch.submit(*r) for r in rounds[i]]
                i += 1
            if sch.has_work:
                prof.maybe_start(sch.step_idx)
                rec = sch.step()
                prof.maybe_stop(rec["step"])
                max_occ = max(max_occ, rec["occupancy"])
                max_queue = max(max_queue, rec["queue_depth"])
    finally:
        prof.close()
        if recorder is not None:
            obs.set_recorder(prev)
            recorder.save(spans_out, process_name="repro_torch.launch.serve")
        if metrics_out:
            sink.close()
    reqs = [sch.done[r] for r in rids]
    total_new = sum(len(r.tokens) for r in reqs)
    summary = {
        "arch": arch, "seed": seed, "n_requests": n_requests,
        "total_steps": sch.step_idx, "total_new_tokens": total_new,
        "max_occupancy": max_occ, "max_queue_depth": max_queue,
        "mean_ttft_steps": round(
            float(np.mean([r.first_token_step - r.submit_step + 1
                           for r in reqs])), 3),
        "decode_tokens_per_s": round(total_new / max(sch.decode_s, 1e-9), 1),
    }
    if not quiet:
        for r in reqs:
            print(f"req{r.rid}: prompt_len={r.prompt_len} "
                  f"tokens={r.output().tolist()}")
        print(summary)
    summary["tokens"] = [r.output().tolist() for r in reqs]
    return summary


def _run_static(args) -> None:
    """One-shot mode: a single batched generate."""
    import numpy as np
    from repro_torch.serving.engine import Engine

    cfg, params = load_model(args.arch, args.smoke, args.seed, args.device,
                             n_layers=args.n_layers)
    eng = Engine(cfg, params, max_len=args.max_len,
                 window_override=args.window_override)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)
    shape = frames_shape(cfg)
    frames = None if shape is None else rng.normal(
        size=(args.batch,) + shape).astype(np.float32)
    out = eng.generate(prompts, n_new=args.new_tokens, frames=frames)
    for i, row in enumerate(out):
        print(f"req{i}: {row.tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the reduced smoke config (default); --no-smoke "
                         "serves the full config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="serve the config at this depth (0: the config's)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--window-override", type=int, default=None,
                    help="serve with a sliding window of this size (a ring "
                         "KV cache)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    # traffic mode (default)
    ap.add_argument("--requests", type=int, default=8,
                    help="total synthetic requests to issue")
    ap.add_argument("--rate", type=float, default=0.7,
                    help="Poisson arrival rate (requests per scheduler step)")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--token-budget", type=int, default=32)
    ap.add_argument("--metrics-out", default=None,
                    help="write serve.step/serve.request JSONL here")
    ap.add_argument("--profile-dir", default="",
                    help="torch.profiler capture dir (a Chrome trace over "
                         "the --profile-start..--profile-stop step window)")
    ap.add_argument("--profile-start", type=int, default=0)
    ap.add_argument("--profile-stop", type=int, default=4)
    ap.add_argument("--spans-out", default="",
                    help="write host-side phase spans as a Chrome trace "
                         "JSON (open in Perfetto)")
    # one-shot mode
    ap.add_argument("--batch", type=int, default=None,
                    help="run one static Engine.generate over this batch "
                         "size instead of the traffic driver")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    args = ap.parse_args(argv)

    if args.batch is not None:
        _run_static(args)
    else:
        run_traffic(arch=args.arch, smoke=args.smoke,
                    n_requests=args.requests, rate=args.rate,
                    max_slots=args.max_slots,
                    prefill_chunk=args.prefill_chunk,
                    token_budget=args.token_budget, max_len=args.max_len,
                    seed=args.seed, metrics_out=args.metrics_out,
                    profile_dir=args.profile_dir,
                    profile_start=args.profile_start,
                    profile_stop=args.profile_stop,
                    spans_out=args.spans_out, device=args.device,
                    window_override=args.window_override,
                    n_layers=args.n_layers)


if __name__ == "__main__":
    main()
