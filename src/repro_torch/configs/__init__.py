from repro_torch.configs.base import (SHAPES, ArchEntry, BlockDef,
                                      LayerSpec, ModelConfig, MoESpec,
                                      ShapeSpec, entry, get, names,
                                      register)

__all__ = [
    "SHAPES", "ArchEntry", "BlockDef", "LayerSpec", "ModelConfig",
    "MoESpec", "ShapeSpec", "entry", "get", "names", "register",
]
