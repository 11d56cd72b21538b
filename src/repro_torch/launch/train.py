"""End-to-end training driver, the port of the reference's
``repro/launch/train.py``: one device, the card unless ``--device`` says
otherwise.

  python -m repro_torch.launch.train --arch musicgen-medium --smoke \
      --steps 12 --batch 4 --seq 64 --device cpu

Wires together: config registry -> train step (launch/steps) ->
deterministic data pipeline (repro_torch.data) -> fault-tolerant loop
(repro_torch.runtime) -> atomic checkpoints (repro_torch.checkpoint).
``main(argv)`` returns ``(state, history)``: the history holds the
runner's ``loss``, ``restarts`` and ``retried``, and ``steps``, one record
per completed step (step, loss, lr, grad_norm, ms).
"""
from __future__ import annotations

import argparse
import logging
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.shapes import ShapeSpec, input_specs
from repro_torch.data import DataConfig, make_source
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime import FaultConfig, TrainLoopRunner

log = logging.getLogger("repro_torch.train")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory; a run resumes from its newest "
                    "step (default: a new temporary directory, removed when "
                    "the run ends)")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--corpus", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--imc-mode", default=None,
                    choices=[None, "fakequant", "imc_analytic"],
                    help="noise-aware training through the IMC layer")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                    "one)")
    return ap.parse_args(argv)


def main(argv=None, failure_injector=None):
    """Train; returns (state, history).  ``failure_injector(step)`` is the
    runner's hook for injected faults (tests)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    if args.imc_mode:
        from repro_torch.core.imc_linear import IMCConfig
        from repro_torch.core.substrate import as_substrate

        # dynamic-policy substrate: per-batch quantizer stats keep STE
        # gradients tracking the live activation ranges (training parity)
        cfg = cfg.replace(
            imc=as_substrate(IMCConfig(mode=args.imc_mode, bx=7, bw=7)))

    specs = input_specs(cfg, ShapeSpec("cli", args.seq, args.batch, "train"))
    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    bundle = steps_lib.build_train_step(cfg, opt_cfg, total_steps=args.steps,
                                        device=device)

    data_cfg = DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, corpus_path=args.corpus,
    )
    source = make_source(data_cfg)

    def batch_fn(step: int):
        b = source.batch(step)
        out = {"tokens": torch.from_numpy(b["tokens"]).to(device)}
        if "prefix_embeds" in specs:
            spec = specs["prefix_embeds"]
            out["prefix_embeds"] = torch.zeros(spec.shape, dtype=spec.dtype,
                                               device=device)
        return out

    records = []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        state, metrics = bundle.step_fn(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        ms = 1000 * (time.perf_counter() - t0)
        step = int(state["step"])
        records.append({"step": step, "loss": loss,
                        "lr": float(metrics["lr"]),
                        "grad_norm": float(metrics["grad_norm"]), "ms": ms})
        if step % args.log_every == 0:
            log.info("step %d loss=%.4f lr=%.2e gnorm=%.3f %.0fms", step,
                     loss, records[-1]["lr"], records[-1]["grad_norm"], ms)
        return state, metrics

    with tempfile.TemporaryDirectory(prefix="repro_train_ckpt_") as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        if args.ckpt_dir is None:
            log.info("no --ckpt-dir: checkpoints go to %s, removed at the "
                     "end", tmp)
        runner = TrainLoopRunner(
            step_fn=step_fn,
            init_state_fn=lambda: bundle.init_state(0),
            batch_fn=batch_fn,
            cfg=FaultConfig(ckpt_dir=ckpt_dir, save_every=args.save_every),
            failure_injector=failure_injector,
        )
        runner.install_preemption_handler()
        state, history = runner.run(args.steps)
    history["steps"] = records
    losses = history["loss"]
    step_ms = [r["ms"] for r in records]
    log.info(
        "done: %d steps, loss %.4f -> %.4f, median step %.0fms, restarts=%d",
        len(losses), losses[0] if losses else float("nan"),
        losses[-1] if losses else float("nan"),
        float(np.median(step_ms)) if step_ms else -1,
        history["restarts"],
    )
    return state, history


if __name__ == "__main__":
    main()
