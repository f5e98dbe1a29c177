"""CLI: ``python -m distributedpytorch_tpu_torch [--config c.json]
[--fake-data] [--validate-only] [--device D] [k=v ...]``.

The counterpart of ``python -m distributedpytorch_tpu``: builds the
``Trainer`` from a JSON config (default: the reference's ``Config``) and
dotted-path overrides, then trains (``fit``) or runs the validation
protocol once.  ``--serve ...`` hands the rest of the command line to
``python -m distributedpytorch_tpu_torch.serve``.  It runs on CUDA unless
``--device cpu`` is given; with no card and no such flag it raises.

    python -m distributedpytorch_tpu_torch --fake-data epochs=2
    python -m distributedpytorch_tpu_torch --device cpu --fake-data \\
        model.backbone=resnet18 "data.crop_size=[64,64]" data.relax=10 \\
        data.area_thres=0 data.train_batch=2 epochs=1
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--serve"]:
        from .serve.__main__ import main as serve_main
        return serve_main(argv[1:])
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
    parser.add_argument("overrides", nargs="*",
                        help="dotted config overrides, e.g. optim.lr=1e-7")
    args = parser.parse_args(argv)

    from .train.config import Config, apply_overrides, from_json
    from .train.trainer import Trainer

    cfg = from_json(args.config) if args.config else Config()
    if args.fake_data:
        cfg = apply_overrides(cfg, {"data.fake": True})
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    trainer = Trainer(cfg, device=args.device)
    try:
        if args.validate_only:
            print(json.dumps(trainer.validate()), flush=True)
        else:
            trainer.fit()
    finally:
        trainer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
