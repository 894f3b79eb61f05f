"""The LM stack's models, the counterpart of ``repro.models``: the ten
architectures as points of one ``ModelConfig``, on PyTorch tensors."""
from .config import ModelConfig, MoEConfig, MLAConfig, EncoderConfig
from .transformer import Transformer
from .common import activation_sharding, params_from_numpy


def build(cfg: ModelConfig) -> Transformer:
    return Transformer(cfg)


__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "EncoderConfig",
           "Transformer", "build", "activation_sharding",
           "params_from_numpy"]
