"""The port's tensor-parallel split of every leaf against JAX's _TP_RULES.

For mla-tiny's bf16, int8 (each package's quantize_model) and int4 trees at
T = 2 and 4, every leaf's tp dim (parallel/sharding.tp_dim) equals the 'tp'
entry of JAX's param_shardings(params, make_mesh(fsdp=1, tp=T), use_tp=True),
and each rank's leaf of params.tp_local equals the data of JAX's
addressable shard on that rank's device, bit for bit; tp_local names the
TP_RULES keys it split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_policy_parity as tpp
from mla_tpu.ops import quantization as jq
from mla_tpu.parallel import make_mesh, sharding as jsharding
from mla_tpu.utils.tree import path_str
from mla_tpu_torch.params import from_jax, tp_local, tree_items
from mla_tpu_torch.parallel import mesh as tmesh
from mla_tpu_torch.parallel import sharding as tsharding

# the leaves JAX splits in mla-tiny's decoder (4 heads of 16, intermediate
# 128, vocabulary 32064), whatever T of 2 and 4: q/k/v/o, gate/up/down and
# the lm_head; the bf16 embedding too, the int8 embedding never (its paths
# end in table_q / table_scale); w_scale under the N-split rules only
SPLIT = {
    "bf16": {"attn/q/w", "attn/k/w", "attn/v/w", "attn/o/w", "mlp/gate/w", "mlp/up/w", "mlp/down/w",
             "embed/table", "lm_head/w"},
    "int8": {"attn/q/w_q", "attn/k/w_q", "attn/v/w_q", "attn/o/w_q", "mlp/gate/w_q", "mlp/up/w_q", "mlp/down/w_q",
             "attn/q/w_scale", "attn/k/w_scale", "attn/v/w_scale", "mlp/gate/w_scale", "mlp/up/w_scale",
             "lm_head/w_q", "lm_head/w_scale"},
    "int4": set(),
}


@pytest.fixture(scope="module")
def trees():
    params, _ = tpp.model(seed=0)
    bf16 = jax.tree_util.tree_map(lambda x: np.asarray(x).astype(jnp.bfloat16)
                                  if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x), params)
    return {"bf16": bf16, "int8": jq.quantize_model(params), "int4": jq.quantize_model_int4(params, group_size=32)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("T", [2, 4])
def test_tp_split_matches_jax(trees, kind, T):
    tree = trees[kind]
    mesh = make_mesh(fsdp=1, tp=T, devices=jax.devices()[:T])
    shardings = jsharding.param_shardings(tree, mesh, use_tp=True)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    shs = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    port = from_jax(tree)
    results = [tp_local(port, tmesh.Mesh(1, 1, T, rank=t)) for t in range(T)]
    locals_ = [dict(tree_items(tree)) for tree, _ in results]
    whole = dict(tree_items(port))
    split, rules = set(), set()
    for (jpath, leaf), sh in zip(flat, shs):
        path = path_str(jpath)
        spec = tuple(sh.spec) + (None,) * (leaf.ndim - len(sh.spec))
        want = spec.index("tp") if "tp" in spec else None
        assert tsharding.tp_dim(path, tuple(leaf.shape), T) == want, path
        if want is None:  # a whole leaf is kept, not copied (JAX replicates it)
            assert all(loc[path] is whole[path] for loc in locals_), path
            continue
        split.add(path.split("llm_backbone/layers/")[-1].split("llm_backbone/")[-1])
        rules.add(tsharding.tp_rule(path))
        arr = jax.device_put(leaf, sh)
        for t in range(T):
            dev = mesh.devices[0, 0, t]
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            got = locals_[t][path]
            assert got.is_contiguous() and got.shape[want] * T == leaf.shape[want]
            np.testing.assert_array_equal(_np(got), np.asarray(shard.data).astype(_np(got).dtype), err_msg=path)
    assert split == SPLIT[kind]
    # the TP_RULES keys the layers ask the tp block for (tensor.split)
    assert all(keys == rules for _, keys in results)
    assert rules == {"bf16": set(tsharding.TP_RULES), "int8": set(tsharding.TP_RULES) - {"embed/table"},
                     "int4": set()}[kind]
