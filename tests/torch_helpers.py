"""Shared pieces of the tests that hold the PyTorch port against the JAX
package: the JAX parameter tree as numpy (bf16 as uint16 bits), and the
tiny llama both packages build."""

import jax
import jax.numpy as jnp
import numpy as np


def to_numpy(tree):
    """A JAX tree as numpy leaves; bf16 leaves as their uint16 bits."""
    def one(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a
    return jax.tree.map(one, tree)


def configs(dtype="bfloat16"):
    """The tiny llama-1.5b of both packages: (jax cfg, torch cfg)."""
    from repro.configs import get as jget
    from repro.configs.tiny import make_tiny as jtiny
    from repro_torch.configs import get as tget
    from repro_torch.configs.tiny import make_tiny as ttiny
    return (jtiny(jget("llama-1.5b")).replace(dtype=dtype),
            ttiny(tget("llama-1.5b")).replace(dtype=dtype))


def bridged_params(jcfg, seed=0):
    """JAX ``init_params`` and the same weights carried into torch."""
    from repro.models.init import init_params
    from repro_torch.models.init import params_from_numpy
    jp = init_params(jcfg, jax.random.key(seed))
    return jp, params_from_numpy(to_numpy(jp), device="cpu")


def as_f32(x) -> np.ndarray:
    """A JAX array or torch tensor as float32 numpy."""
    if hasattr(x, "detach"):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))
