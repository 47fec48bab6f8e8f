"""Training launcher: the port of the JAX package's ``repro.launch.train``.

Runs on the CUDA card unless asked for the CPU (``--device cpu``); the FrODO
update goes through the hand-written kernels unless ``--no-use-kernel``.

    PYTHONPATH=src python -m repro_torch.launch.train --device cuda \\
        --arch h2o-danube-1.8b --n-layers 8 --seq 4096 --memory-mode expsum \\
        --T 90 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \\
        --steps 4 --seq 32 --batch-per-agent 1

``run_training`` is the importable entry point: same seed -> same data
stream, same init, same trajectories.  The JAX launcher's
``--force-devices`` (an XLA host-device flag) belongs to the distributed
slice and is not ported.
"""
import argparse
from typing import Callable, Optional


def run_training(arch: str = "h2o-danube-1.8b", smoke: bool = True,
                 steps: int = 20, agents: int = 2, seq: int = 128,
                 batch_per_agent: int = 2, optimizer: str = "frodo",
                 alpha: float = 0.02, beta: float = 0.008,
                 lam: float = 0.15, T: int = 40,
                 memory_mode: str = "exact", topology: str = "complete",
                 consensus_interval: int = 1, ckpt_dir: str = "checkpoints",
                 metrics_out: str = "", collect_metrics: bool = False,
                 seed: int = 0, profile_dir: str = "",
                 profile_start: int = 0, profile_stop: int = 4,
                 spans_out: str = "", device=None, use_kernel: bool = True,
                 n_layers: int = 0, acc_dtype: str = "float32",
                 param_dtype: str = "",
                 init_fn: Optional[Callable[[int], dict]] = None):
    """Run the training loop; returns the trainer (history attached, and
    its last ``profile`` window).

    The arguments are the JAX launcher's, plus: ``device`` (``cuda`` by
    default, which raises without a card; ``"cpu"`` on purpose);
    ``use_kernel`` (the FrODO update through the hand-written kernels; the
    JAX launcher leaves ``TrainConfig.use_kernel`` at False); ``n_layers``
    (cut the depth, 0 keeps the config's); ``acc_dtype`` (exp-sum
    accumulators); ``param_dtype`` (param and compute dtype, "" keeps the
    config's); ``init_fn(seed)`` (initial stacked parameters as a numpy
    tree, for example the JAX package's, instead of the port's own draw).
    """
    from repro_torch import obs
    from repro_torch.configs import registry as REG
    from repro_torch.data.synthetic import TokenPipeline, augment_modalities
    from repro_torch.training.train_step import TrainConfig
    from repro_torch.training.trainer import Trainer

    cfg = REG.get_smoke_config(arch) if smoke else REG.get_config(arch)
    if n_layers:
        cfg = cfg.replace(n_layers=n_layers)
    if param_dtype:
        cfg = cfg.replace(param_dtype=param_dtype, compute_dtype=param_dtype)
    collect = collect_metrics or bool(metrics_out)
    tc = TrainConfig(optimizer=optimizer, alpha=alpha, beta=beta,
                     lam=lam, T=T, memory_mode=memory_mode, remat=not smoke,
                     topology=topology, acc_dtype=acc_dtype,
                     use_kernel=use_kernel,
                     consensus_interval=consensus_interval,
                     collect_metrics=collect)
    tokens_per_step = agents * batch_per_agent * seq
    trainer = Trainer(cfg, tc, n_agents=agents,
                      ckpt_dir=ckpt_dir, log_every=5,
                      tokens_per_step=tokens_per_step,
                      profile_dir=profile_dir or None,
                      profile_start=profile_start,
                      profile_stop=profile_stop, device=device)
    data = augment_modalities(
        iter(TokenPipeline(vocab=cfg.vocab, seq_len=seq,
                           batch_per_agent=batch_per_agent,
                           n_agents=agents, seed=seed)), cfg)
    sink = obs.JsonlSink(metrics_out) if metrics_out else None
    trainer.sink = sink
    recorder = obs.SpanRecorder() if spans_out else None
    prev = obs.set_recorder(recorder) if recorder is not None else None
    try:
        # the state goes straight to run(): a reference kept here would
        # hold the initial parameters for the whole run
        trainer.run(trainer.init(seed=seed,
                                 params=init_fn(seed) if init_fn else None),
                    data, steps)
    finally:
        if recorder is not None:
            obs.set_recorder(prev)
            recorder.save(spans_out, process_name="repro_torch.launch.train")
        if sink is not None:
            sink.close()
    return trainer


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--agents", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch-per-agent", type=int, default=2)
    ap.add_argument("--optimizer", default="frodo")
    ap.add_argument("--alpha", type=float, default=0.02)
    ap.add_argument("--beta", type=float, default=0.008)
    ap.add_argument("--lam", type=float, default=0.15)
    ap.add_argument("--T", type=int, default=40)
    ap.add_argument("--memory-mode", default="exact",
                    choices=("exact", "expsum"))
    ap.add_argument("--acc-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="exp-sum accumulator dtype")
    ap.add_argument("--topology", default="complete")
    ap.add_argument("--consensus-interval", type=int, default=1)
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the model's depth (0: the config's)")
    ap.add_argument("--param-dtype", default="",
                    choices=("", "float32", "bfloat16"),
                    help="param and compute dtype ('': the config's)")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds init + data stream (deterministic run)")
    ap.add_argument("--metrics-out", default="",
                    help="JSONL path for per-step telemetry (implies "
                         "--collect-metrics)")
    ap.add_argument("--collect-metrics", action="store_true",
                    help="compute consensus_error/memory_norm/... in-step")
    ap.add_argument("--profile-dir", default="",
                    help="torch.profiler capture dir (a Chrome trace over "
                         "the --profile-start..--profile-stop step window)")
    ap.add_argument("--profile-start", type=int, default=0)
    ap.add_argument("--profile-stop", type=int, default=4)
    ap.add_argument("--spans-out", default="",
                    help="write host-side phase spans as a Chrome trace "
                         "JSON (open in Perfetto)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--use-kernel", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="FrODO update through the hand-written kernels")
    args = ap.parse_args(argv)

    run_training(arch=args.arch, smoke=args.smoke, steps=args.steps,
                 agents=args.agents, seq=args.seq,
                 batch_per_agent=args.batch_per_agent,
                 optimizer=args.optimizer, alpha=args.alpha, beta=args.beta,
                 lam=args.lam, T=args.T, memory_mode=args.memory_mode,
                 topology=args.topology,
                 consensus_interval=args.consensus_interval,
                 ckpt_dir=args.ckpt_dir, metrics_out=args.metrics_out,
                 collect_metrics=args.collect_metrics, seed=args.seed,
                 profile_dir=args.profile_dir,
                 profile_start=args.profile_start,
                 profile_stop=args.profile_stop, spans_out=args.spans_out,
                 device=args.device, use_kernel=args.use_kernel,
                 n_layers=args.n_layers, acc_dtype=args.acc_dtype,
                 param_dtype=args.param_dtype)


if __name__ == "__main__":
    main()
