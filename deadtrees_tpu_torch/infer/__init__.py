from deadtrees_tpu_torch.infer.engine import Inference, TorchInference, resolve_device
from deadtrees_tpu_torch.infer.packing import pack2, unpack2

__all__ = ["Inference", "TorchInference", "pack2", "resolve_device", "unpack2"]
