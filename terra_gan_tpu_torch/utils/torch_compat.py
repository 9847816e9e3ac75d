"""The JAX package's variables as reference-layout torch state dicts.

The port's own numpy-only copy of the conversions it needs from
terra_gan_tpu/utils/torch_compat.py (``generator_vars_to_torch_state``,
``discriminator_vars_to_torch_state`` and the OIHW/HWIO helpers), so
that carrying weights across imports nothing of the JAX package. The
variables are the flax pytrees as nested dicts of numpy arrays:

  * generator: ``params[blk] = {kernel (HWIO), bias, bn: {scale, bias}}``
    for ``enc1..enc7, dec7..dec1``, ``params[final_kernel|final_bias]``,
    ``batch_stats[blk]["bn"] = {mean, var}``; out come the keys
    ``blk.input_conv.*``, ``blk.mask_conv.weight`` (the frozen all-ones
    conv), ``blk.bn.*`` and ``final.*``;
  * discriminator: ``params[{block0..block3,final}_kernel|_bias]`` and
    ``params[blockN_bn]`` with ``batch_stats[blockN_bn]``; out come
    ``model.{0,2,5,8,11}.*`` convs and ``model.{3,6,9}.*`` BatchNorms.

Conv weights go HWIO -> OIHW.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

GEN_BLOCKS = [f"enc{i}" for i in range(1, 8)] + [f"dec{i}" for i in range(7, 0, -1)]
# (torch Sequential index, flax name, has batch norm)
DISC_BLOCKS = [(0, "block0", False), (2, "block1", True), (5, "block2", True),
               (8, "block3", True), (11, "final", None)]


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v.copy()
    try:  # a torch tensor; copied so that in-place torch updates cannot alias it
        return v.detach().cpu().numpy().copy()
    except AttributeError:
        return np.asarray(v)


def _oihw_to_hwio(w: Any) -> np.ndarray:
    return np.transpose(_to_numpy(w), (2, 3, 1, 0))


def _hwio_to_oihw(w: Any) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _bn_entries(sd: Dict[str, np.ndarray], prefix: str, bn: Mapping, st: Mapping) -> None:
    sd[f"{prefix}.weight"] = np.asarray(bn["scale"])
    sd[f"{prefix}.bias"] = np.asarray(bn["bias"])
    sd[f"{prefix}.running_mean"] = np.asarray(st.get("mean", np.zeros_like(bn["scale"])))
    sd[f"{prefix}.running_var"] = np.asarray(st.get("var", np.ones_like(bn["scale"])))
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def generator_vars_to_torch_state(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Generator variables -> torch-key state dict (numpy values)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for blk in GEN_BLOCKS:
        p = params[blk]
        sd[f"{blk}.input_conv.weight"] = _hwio_to_oihw(p["kernel"])
        sd[f"{blk}.input_conv.bias"] = np.asarray(p["bias"])
        k = np.asarray(p["kernel"]).shape[0]
        sd[f"{blk}.mask_conv.weight"] = np.ones((1, 1, k, k), np.float32)
        if "bn" in p:
            _bn_entries(sd, f"{blk}.bn", p["bn"], stats.get(blk, {}).get("bn", {}))
    sd["final.weight"] = _hwio_to_oihw(params["final_kernel"])
    sd["final.bias"] = np.asarray(params["final_bias"])
    return sd


def discriminator_vars_to_torch_state(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Discriminator variables -> torch-key state dict (numpy values)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for idx, name, has_bn in DISC_BLOCKS:
        sd[f"model.{idx}.weight"] = _hwio_to_oihw(params[f"{name}_kernel"])
        sd[f"model.{idx}.bias"] = np.asarray(params[f"{name}_bias"])
        if has_bn:
            _bn_entries(sd, f"model.{idx + 1}", params[f"{name}_bn"],
                        stats.get(f"{name}_bn", {}))
    return sd
