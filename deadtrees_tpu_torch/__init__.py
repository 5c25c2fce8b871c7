"""deadtrees-tpu-torch: the PyTorch/CUDA port of ``deadtrees_tpu``.

The JAX package stays the reference; this package mirrors its module paths
and public names, in PyTorch idiom (NCHW ``nn.Module``s with the reference
smp state-dict layout, explicit devices and generators). Its entry points
run on a CUDA device unless the caller asks for ``device="cpu"``.

Subpackages ported so far (the serving and training paths of the model
of record):
    data    — dataset constants, augmentation, tar shards, the data module
    models  — EfficientUnet++ on the EfficientNet-b0..b7 encoders
    ops     — the fused, BN-folded decoder InvertedResidual (two CUDA
              kernels) and the fused colour jitter + normalize (one CUDA
              kernel), built at first CUDA use
    losses  — one-hot helpers, the exact EDT, the loss suite, metrics
    train   — compound loss, optimizer, train/eval steps, ``Trainer``
    core    — checkpoint files in the JAX package's ``DTPU1`` format
    infer   — ``TorchInference`` and 2-bit class-map packing
    serve   — the REST segmentation service

Importing the package needs neither a GPU nor a CUDA compiler.
"""

from deadtrees_tpu_torch.version import __version__

__all__ = ["__version__"]
