"""Package CLI: ``python -m deadtrees_tpu_torch version|train|eval``.

Counterpart of ``python -m deadtrees_tpu``: ``train`` and ``eval`` take
the config overrides (``key=value``) of the JAX CLI, and ``--device``
(CUDA by default; ``--device cpu`` runs on the CPU).
"""

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deadtrees-tpu-torch")
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("version", help="print package version")
    for name, what in (("train", "run training"), ("eval", "test bestmodel=<ckpt>")):
        p = sub.add_parser(name, help=what)
        p.add_argument("overrides", nargs="*", help="config overrides key=value")
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' runs on the CPU)")

    args = parser.parse_args(argv)

    if args.command == "version":
        from deadtrees_tpu_torch.version import __version__

        print(__version__)
        return 0
    if args.command == "train":
        from deadtrees_tpu_torch.train.entry import train_from_cli

        train_from_cli(args.overrides, device=args.device)
        return 0
    if args.command == "eval":
        from deadtrees_tpu_torch.train.entry import eval_from_cli

        eval_from_cli(args.overrides, device=args.device)
        return 0

    parser.print_help()
    return 1


if __name__ == "__main__":
    sys.exit(main())
