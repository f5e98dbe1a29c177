"""CLI: ``python -m distributedpytorch_tpu_torch [--config c.json]
[--fake-data] [--validate-only] [--device D] [--dist-backend B] [k=v ...]``.

The counterpart of ``python -m distributedpytorch_tpu``: builds the
``Trainer`` from a JSON config (default: the reference's ``Config``) and
dotted-path overrides, then trains (``fit``) or runs the validation
protocol once.  ``--serve ...`` hands the rest of the command line to
``python -m distributedpytorch_tpu_torch.serve``.  It runs on CUDA unless
``--device cpu`` is given; with no card and no such flag it raises.

Data parallelism, one process per card:

* under ``torchrun`` (its ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/
  ``MASTER_ADDR``/``MASTER_PORT`` in the environment) the process joins
  the group they describe and trains as its rank;
* otherwise, on a host with more than one visible card, it spawns one
  rank per card (the ``spawn`` start method, a TCP store on localhost),
  after building the kernels once for all of them, and waits: a rank that
  dies ends the others, and the exit code is non-zero with the dead rank
  named.  SIGTERM is passed on to every rank (each stops by consensus);
* on one card it is one process, the plain path.

``--dist-backend`` is NCCL on CUDA by default, gloo on the CPU; gloo also
lets two ranks share a card, which NCCL refuses.

    python -m distributedpytorch_tpu_torch --fake-data epochs=2
    torchrun --nproc-per-node 4 -m distributedpytorch_tpu_torch \\
        data.root=VOC parallel.strategy=dp_zero1
    python -m distributedpytorch_tpu_torch --device cpu --fake-data \\
        model.backbone=resnet18 "data.crop_size=[64,64]" data.relax=10 \\
        data.area_thres=0 data.train_batch=2 epochs=1
"""

from __future__ import annotations

import argparse
import json
import sys


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="distributedpytorch_tpu_torch",
        description="Interactive-segmentation training on PyTorch/CUDA",
        epilog="Serving: `python -m distributedpytorch_tpu_torch --serve ...`")
    parser.add_argument("--config", help="JSON config file")
    parser.add_argument("--fake-data", action="store_true",
                        help="the in-memory synthetic VOC fixture")
    parser.add_argument("--validate-only", action="store_true",
                        help="run the validation protocol once and exit")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; cpu only on request)")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="process-group backend (default nccl on CUDA, "
                             "gloo on the CPU)")
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides, e.g. optim.lr=1e-7")
    return parser


def _run(args, device) -> int:
    from .train.config import Config, apply_overrides, from_json
    from .train.trainer import Trainer

    cfg = from_json(args.config) if args.config else Config()
    if args.fake_data:
        cfg = apply_overrides(cfg, {"data.fake": True})
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    trainer = Trainer(cfg, device=device)
    try:
        if args.validate_only:
            metrics = trainer.validate()
            if trainer.is_main:
                print(json.dumps(metrics), flush=True)
        else:
            trainer.fit()
    finally:
        trainer.close()
    return 0


def _run_rank(args) -> int:
    """One rank of a torchrun-described group."""
    from .parallel import mesh

    device = mesh.initialize_distributed(
        backend=args.dist_backend,
        device="cpu" if args.device == "cpu" else "cuda")
    try:
        return _run(args, device)
    finally:
        mesh.destroy_distributed()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--serve"]:
        from .serve.__main__ import main as serve_main
        return serve_main(argv[1:])
    args = _parser().parse_args(argv)

    from .parallel.mesh import launched_by_torchrun

    if launched_by_torchrun():
        return _run_rank(args)
    if args.device is None or str(args.device) == "cuda":
        import torch

        n = torch.cuda.device_count()
        if n > 1:
            from .parallel.launch import spawn_ranks
            return spawn_ranks(argv, n)
    return _run(args, args.device)


if __name__ == "__main__":
    sys.exit(main())
