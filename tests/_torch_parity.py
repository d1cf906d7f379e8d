"""Helpers the port's parity tests share: numpy trees handed to both
packages, tolerances and the comparisons that use them. Imported by the
``test_torch_*`` files, which run only where torch and JAX both are."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.modules import is_spec as jax_is_spec
from repro_torch.models.bridge import tree_from_numpy
from repro_torch.models.modules import ParamSpec

# f32 on both sides; the sums run in another order (pairwise einsums,
# torch's matmul blocking), so results agree to float rounding, not bits
TOL = 1e-4

# bf16 keeps 8 significant bits (2^-8 relative a rounding). The port and
# the reference round at other places (XLA keeps excess precision inside
# its fusions, eager PyTorch rounds after every op), so their bf16 logits
# differ by rounding alone: 0.5 % relative L2 after one smoke layer, 2-4 %
# after a smoke config's three or four, as far as the reference's own bf16
# logits lie from its f32 ones. Held at 5 % relative L2. Logits that
# computed something else land near 1.4 (two unrelated vectors of one
# norm).
BF16_TOL = 0.05


def perturb(tree, seed: int):
    """numpy copy of a reference tree; constant leaves get random values."""
    rng = np.random.default_rng(seed)

    def one(a):
        a = np.asarray(a)
        if a.dtype.kind == "f" and a.size and np.all(a == a.flat[0]):
            a = (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(one, tree)


def both(tree_np):
    """The same numpy tree as JAX arrays and as CPU tensors."""
    return jax.tree.map(jnp.asarray, tree_np), tree_from_numpy(tree_np, "cpu")


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def rel_l2(got: torch.Tensor, want) -> float:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def match(got: torch.Tensor, want, bf16: bool):
    """Port logits against the reference's: to float rounding in f32,
    within BF16_TOL relative L2 in bf16."""
    if bf16:
        assert got.dtype == torch.bfloat16
        assert rel_l2(got, want) <= BF16_TOL
    else:
        close(got, want)


def cfg_dict(cfg) -> dict:
    def norm(v):
        if isinstance(v, torch.dtype):
            return str(v).removeprefix("torch.")
        if isinstance(v, type) and hasattr(v, "dtype"):
            return jnp.dtype(v).name
        return v
    return {k: norm(v) for k, v in dataclasses.asdict(cfg).items()}


# the port's own config fields (granite-4.0-h-small's family, which the
# reference does not have) at the values that leave every other arch as
# the reference has it
PORT_FIELDS = {"layer_types": (), "embedding_multiplier": 1.0,
               "residual_multiplier": 1.0, "logits_scaling": 1.0,
               "attention_multiplier": 0.0}
PORT_MOE_FIELDS = {"shared_d_ff": 0, "held_experts": 0, "first_held": 0}


def port_fields(got: dict, want: dict) -> dict:
    """The entries of the port's ``cfg_dict`` ``got`` that the reference's
    ``want`` lacks, at any depth, taken out of ``got``."""
    out = {}
    for k in list(got):
        if k not in want:
            out[k] = got.pop(k)
        elif isinstance(got[k], dict) and isinstance(want[k], dict):
            sub = port_fields(got[k], want[k])
            if sub:
                out[k] = sub
    return out


def spec_rows_ref(defs):
    leaves = jax.tree_util.tree_flatten_with_path(defs, is_leaf=jax_is_spec)
    return [(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path),
             s.shape, jnp.dtype(s.dtype).name, s.init, s.init_scale,
             s.logical_axes) for path, s in leaves[0]]


def spec_rows_port(defs, path=()):
    if isinstance(defs, ParamSpec):
        return [(path, defs.shape, str(defs.dtype).removeprefix("torch."),
                 defs.init, defs.init_scale, defs.logical_axes)]
    keys = range(len(defs)) if isinstance(defs, list) else sorted(defs)
    return [r for k in keys for r in spec_rows_port(defs[k], path + (k,))]
