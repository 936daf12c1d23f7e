from repro_torch.configs.base import (ArchEntry, BlockDef, LayerSpec,
                                      ModelConfig, MoESpec, entry, get,
                                      names, register)

__all__ = [
    "ArchEntry", "BlockDef", "LayerSpec", "ModelConfig", "MoESpec",
    "entry", "get", "names", "register",
]
