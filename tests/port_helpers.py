"""Parameter-tree helpers shared by the tests that hold the PyTorch port
against the JAX package: both sides take the same numpy values."""

import jax
import numpy as np
import torch


def flat_params(tree, prefix=""):
    """Nested dicts of arrays -> {"a.b.c": float32 array}, the port's names."""

    out = {}
    for key, value in dict(tree).items():
        if hasattr(value, "items"):
            out.update(flat_params(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value, np.float32)
    return out


def unflat_params(flat):
    """The inverse of :func:`flat_params`: a flax-style nested dict."""

    tree = {}
    for name, value in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value, np.float32)
    return tree


def perturb(tree, seed, scale=0.05):
    """``tree`` plus seeded numpy noise on every leaf, so that no head is zero."""

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32)
        + (scale * rng.standard_normal(np.shape(a))).astype(np.float32),
        unflat_params(flat_params(tree)),
    )


def load_tree(module, tree):
    """Load a flax-style tree into a port module (strict) and set eval mode."""

    module.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in flat_params(tree).items()})
    return module.eval()
