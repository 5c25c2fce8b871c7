"""deadtrees-tpu-torch: the PyTorch/CUDA port of ``deadtrees_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, in PyTorch idiom (NCHW ``nn.Module``s with the reference
smp state-dict layout, explicit devices and generators). Its entry points
run on a CUDA device unless the caller asks for ``device="cpu"``.

Subpackages ported so far (the serving, scene and training paths of the
model of record):
    data    — dataset constants, augmentation, tar shards, the data module
    models  — EfficientUnet++ on the EfficientNet-b0..b7 encoders
    ops     — the fused, BN-folded decoder InvertedResidual, its NHWC pair,
              the depthwise conv and the fused colour jitter + normalize
              (hand-written CUDA kernels, built at first CUDA use)
    losses  — one-hot helpers, the exact EDT, the loss suite, metrics
    train   — compound loss, optimizer (its state in the JAX package's
              bytes), train/eval steps, ``Trainer`` and ``train()``: the
              recipe with SWA, resume, preemption and test after training
    core    — checkpoint files in the JAX package's ``DTPU1`` format, the
              asynchronous writer
    infer   — ``TorchInference``, TTA, quantization, scenes, the ensemble
    geo     — retile and mosaic
    serve   — the REST segmentation service
    config  — Hydra-style YAML composition of the repo's ``configs/``
    visualization — sample grids and confusion-matrix figures
    utils   — env, logging, timer

``python -m deadtrees_tpu_torch version|train|eval`` is the CLI.

Importing the package needs neither a GPU nor a CUDA compiler.
"""

from deadtrees_tpu_torch.version import __version__

__all__ = ["__version__"]
