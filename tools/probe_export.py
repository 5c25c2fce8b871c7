#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 16 alone on a CUDA card.

    python3 tools/probe_export.py

Builds the EfficientUNet++/b5 flagship checkpoint from seed 0 as phase 3
does (under ``build/probe_export/``), then runs phase 16: the float and
int8 artifacts exported on the card and one on the CPU, each served at bs
1 and 4 against the engine it stands for, ``run()`` at bs 4 beside the
plain engine in turns, and a service that serves the artifact alone. The
last line is phase 16's JSON object with the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_export: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from deadtrees_tpu_torch.core.compile_opts import disable_compile

    chip_smoke.set_precision()
    card = chip_smoke.card_line()
    ckpt = REPO / "build" / "probe_export" / "flagship_b5.ckpt"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    chip_smoke.build_flagship(ckpt)
    with disable_compile():
        result = chip_smoke.phase_export(ckpt, card)
        result["timings"] = chip_smoke.phase_export_timings(ckpt, result, card)
    print(json.dumps(dict(result, card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
