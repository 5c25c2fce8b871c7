"""Package CLI: ``python -m deadtrees_tpu_torch version|train|eval|export``.

Counterpart of ``python -m deadtrees_tpu``: ``train`` and ``eval`` take
the config overrides (``key=value``) of the JAX CLI, and ``--device``
(CUDA by default; ``--device cpu`` runs on the CPU) and, under
``python -m torch.distributed.run --nproc-per-node N``, ``--backend``
(``nccl`` or ``gloo``; default NCCL on CUDA, gloo on the CPU).
``export CHECKPOINT
[OUTFILE] [--image-size N]`` is the JAX package's
``scripts/create_export.py``: it writes the exported inference artifact
(``infer/export.py``), by default next to the checkpoint with the suffix
``.ptexp``.
"""

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deadtrees-tpu-torch")
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("version", help="print package version")
    for name, what in (("train", "run training"), ("eval", "test bestmodel=<ckpt>")):
        p = sub.add_parser(name, help=what)
        p.add_argument("overrides", nargs="*", help="config overrides key=value")
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' runs on the CPU)")
        p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                       help="process-group backend under torch.distributed.run "
                            "(default: nccl on CUDA, gloo on the CPU)")

    p = sub.add_parser("export", help="write the exported inference artifact")
    p.add_argument("checkpoint", type=Path)
    p.add_argument("outfile", type=Path, nargs="?", default=None)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device to trace on (default: cuda; 'cpu' runs on the CPU)")

    args = parser.parse_args(argv)

    if args.command == "version":
        from deadtrees_tpu_torch.version import __version__

        print(__version__)
        return 0
    if args.command == "train":
        from deadtrees_tpu_torch.train.entry import train_from_cli

        train_from_cli(args.overrides, device=args.device, backend=args.backend)
        return 0
    if args.command == "eval":
        from deadtrees_tpu_torch.train.entry import eval_from_cli

        eval_from_cli(args.overrides, device=args.device, backend=args.backend)
        return 0
    if args.command == "export":
        from deadtrees_tpu_torch.infer.export import SUFFIX, export_inference

        outfile = args.outfile or args.checkpoint.with_suffix(SUFFIX)
        export_inference(args.checkpoint, outfile, image_size=args.image_size,
                         device=args.device)
        print(f"wrote {outfile}")
        return 0

    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
