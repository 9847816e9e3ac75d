"""The port's PConvUNet against the JAX package's, and weights across packages.

Both packages get the same variables (JAX init, BatchNorm parameters and
running statistics randomised in numpy) and the same inputs; the eval
forward is held to NRMSE <= 1e-5 over the whole composite and to 1e-6
over dec2's and dec1's features, where the signal is: with random
weights the holes of the composite sit near sigmoid(0) with little
spread. The eval forward runs the tail as one fused call, so the port's
dec1 features come from its unfused tail on the same dec2 output. The .pth round
trips go both ways with strict loading.
"""

from __future__ import annotations

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from terra_gan_tpu.evaluation.inference import load_generator_variables
from terra_gan_tpu.models import Discriminator as JaxDiscriminator
from terra_gan_tpu.models import PConvUNet as JaxPConvUNet
from terra_gan_tpu.utils import torch_compat as jax_compat
from terra_gan_tpu.utils.torch_compat import generator_vars_to_torch_state, save_pth
from terra_gan_tpu_torch.models import PConvUNet
from terra_gan_tpu_torch.ops.cuda.pconv_kernel import fused_pconv_eval
from terra_gan_tpu_torch.ops.resize import upsample2x_bilinear
from terra_gan_tpu_torch.utils import device as tdevice
from terra_gan_tpu_torch.utils import torch_compat as port_compat
from terra_gan_tpu_torch.utils import weights as tweights
from terra_gan_tpu_torch.utils.weights import (
    generator_from_jax_variables,
    init_generator,
    load_generator,
)

NRMSE_TOL = 1e-5       # the composite
FEAT_NRMSE_TOL = 1e-6  # dec2's and dec1's features: fp32 order ~2e-8 here, TF32 ~3e-5 on a card
REPO = Path(__file__).resolve().parent.parent


def nrmse(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / max(np.abs(b).max(), 1e-12))


def jax_variables(width: int, seed: int = 0):
    """JAX init, then BatchNorm parameters and statistics randomised in numpy."""
    g = JaxPConvUNet(base_width=width)
    z = jnp.zeros((1, 64, 64, 1))
    v = jax.jit(g.init, static_argnums=3)(jax.random.PRNGKey(seed), z, z + 1, False)
    v = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), v)
    rng = np.random.default_rng(seed)
    for blk, stats in v["batch_stats"].items():
        c = stats["bn"]["mean"].shape[0]
        stats["bn"]["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        stats["bn"]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        v["params"][blk]["bn"]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        v["params"][blk]["bn"]["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
    return g, v


def tiles(hw: int, seed: int = 1, n: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.random((n, hw, hw, 1), dtype=np.float32)
    m = (rng.random((n, hw, hw, 1)) > 0.3).astype(np.float32)
    m[:, hw // 8 : hw // 2, hw // 4 : 3 * hw // 4] = 0
    return x, m


def jax_forward(g, v, x, m):
    return np.asarray(jax.jit(lambda v, a, b: g.apply(v, a * b, b, False))(v, x, m))


def jax_forward_feats(g, v, x, m):
    """(composite, dec2's and dec1's output features) of the JAX model."""
    def run(v, a, b):
        return g.apply(
            v, a * b, b, False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, method: (
                mdl.name in ("dec2", "dec1") and method == "__call__"),
        )

    out, state = jax.jit(run)(v, x, m)
    feats = state["intermediates"]
    return (np.asarray(out), np.asarray(feats["dec2"]["__call__"][0][0]),
            np.asarray(feats["dec1"]["__call__"][0][0]))


def port_forward(model, x, m):
    with torch.inference_mode():
        return model(torch.from_numpy(x * m), torch.from_numpy(m)).numpy()


def port_forward_feats(model, x, m):
    """(composite, dec2's and dec1's output features) of the port's model;
    dec1's from the unfused tail on the forward's own dec2 output."""
    feats = {}
    hooks = [getattr(model, n).register_forward_hook(
        lambda mod, args, out, n=n: feats.setdefault(n, out)) for n in ("dec2", "dec1")]
    try:
        out = port_forward(model, x, m)
        with torch.inference_mode():
            xt, mt = torch.from_numpy(x * m), torch.from_numpy(m)
            model.tail_forward(*feats["dec2"], xt, mt, fused_pconv_eval, upsample2x_bilinear)
    finally:
        for hook in hooks:
            hook.remove()
    return out, feats["dec2"][0].numpy(), feats["dec1"][0].numpy()


@pytest.fixture(scope="module")
def w8():
    return jax_variables(8)


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("hw", [64, 128])  # 64: the deep stages crop in pad_to_match
def test_eval_forward_matches_jax(w8, width, hw):
    g, v = w8 if width == 8 else jax_variables(width)
    x, m = tiles(hw)
    want, want_dec2, want_dec1 = jax_forward_feats(g, v, x, m)
    got, got_dec2, got_dec1 = port_forward_feats(generator_from_jax_variables(v, width, "cpu"), x, m)
    assert got.shape == want.shape == x.shape
    assert got_dec2.shape == want_dec2.shape == (x.shape[0], x.shape[1] // 2, x.shape[2] // 2, width)
    assert got_dec1.shape == want_dec1.shape == (*x.shape[:3], width)
    assert nrmse(got, want) <= NRMSE_TOL
    assert nrmse(got_dec2, want_dec2) <= FEAT_NRMSE_TOL
    assert nrmse(got_dec1, want_dec1) <= FEAT_NRMSE_TOL
    holes = m == 0
    np.testing.assert_array_equal(got[~holes], (x * m)[~holes])


def test_state_dict_keys_are_the_reference_keys(w8):
    _, v = w8
    sd = PConvUNet(8).state_dict()
    ref = generator_vars_to_torch_state(v)
    assert set(sd) == set(ref)
    for key, val in ref.items():
        assert tuple(sd[key].shape) == np.asarray(val).shape, key
    assert torch.equal(sd["enc1.mask_conv.weight"], torch.ones(1, 1, 7, 7))


def assert_same_state(got, want):
    """Key for key, in order, and bit for bit."""
    assert list(got) == list(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("batch_stats", [True, False])  # absent statistics: zeros and ones
def test_port_torch_compat_is_the_jax_modules_bit_for_bit(w8, batch_stats):
    _, gv = w8
    z = jnp.zeros((1, 64, 64, 1))
    dv = jax.jit(JaxDiscriminator(base_width=8).init, static_argnums=2)(jax.random.PRNGKey(1), z, False)
    dv = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), dv)
    if not batch_stats:
        gv, dv = {"params": gv["params"]}, {"params": dv["params"]}
    assert_same_state(port_compat.generator_vars_to_torch_state(gv),
                      jax_compat.generator_vars_to_torch_state(gv))
    assert_same_state(port_compat.discriminator_vars_to_torch_state(dv),
                      jax_compat.discriminator_vars_to_torch_state(dv))
    w = np.random.default_rng(0).random((8, 4, 3, 5), dtype=np.float32)
    for conv in (w, torch.from_numpy(w)):
        assert port_compat._oihw_to_hwio(conv).tobytes() == jax_compat._oihw_to_hwio(conv).tobytes()
    assert port_compat._hwio_to_oihw(w).tobytes() == jax_compat._hwio_to_oihw(w).tobytes()


@pytest.mark.parametrize("build", [
    lambda: tweights.init_generator(8, torch.Generator().manual_seed(0)),
    lambda: tweights.init_discriminator(8, torch.Generator().manual_seed(0)),
    lambda: tweights.init_vgg(torch.Generator().manual_seed(0)),
])
def test_constructors_default_to_the_card(monkeypatch, build):
    """No CUDA, no device named: the constructor raises rather than build on the CPU."""
    monkeypatch.setattr(tdevice.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_load_generator_defaults_to_the_card(w8, tmp_path, monkeypatch):
    _, v = w8
    path = tmp_path / "g.pth"
    save_pth(path, generator_vars_to_torch_state(v))
    monkeypatch.setattr(tdevice.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tweights.load_generator(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tweights.generator_from_jax_variables(v, 8)
    assert tweights.load_generator(path, "cpu").base_width == 8


def test_pth_round_trip_port_to_jax(w8, tmp_path):
    g, v = w8
    model = generator_from_jax_variables(v, 8, "cpu")
    path = tmp_path / "port.pth"
    torch.save({"generator_state_dict": model.state_dict()}, path)
    x, m = tiles(64, seed=2)
    got = jax_forward(g, load_generator_variables(path), x, m)
    assert nrmse(got, port_forward(model, x, m)) <= NRMSE_TOL


def test_pth_round_trip_jax_to_port(w8, tmp_path):
    g, v = w8
    path = tmp_path / "jax.pth"
    save_pth(path, generator_vars_to_torch_state(v))
    model = load_generator(path, "cpu")  # strict=True inside
    assert model.base_width == 8 and not model.training
    x, m = tiles(64, seed=3)
    assert nrmse(port_forward(model, x, m), jax_forward(g, v, x, m)) <= NRMSE_TOL


def test_plain_forward_is_the_forward_on_cpu():
    model = init_generator(8, torch.Generator().manual_seed(4), "cpu")
    x, m = tiles(64, seed=4)
    xt, mt = torch.from_numpy(x * m), torch.from_numpy(m)
    with torch.inference_mode():
        assert torch.equal(model(xt, mt), model.forward_plain(xt, mt))


def test_init_generator_is_seeded_and_draws_batch_norm():
    a = init_generator(8, torch.Generator().manual_seed(5), "cpu").state_dict()
    b = init_generator(8, torch.Generator().manual_seed(5), "cpu").state_dict()
    c = init_generator(8, torch.Generator().manual_seed(6), "cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc3.input_conv.weight"], c["enc3.input_conv.weight"])
    assert (a["dec2.bn.running_var"] > 0).all()
    assert not torch.equal(a["dec2.bn.running_mean"], torch.zeros(8))
    assert not torch.equal(a["enc1.bn.weight"], torch.ones(8))


def test_train_mode_runs_and_updates_batch_norm_statistics():
    model = init_generator(8, torch.Generator().manual_seed(7), "cpu").train()
    x, m = tiles(64)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = model(torch.from_numpy(x * m), torch.from_numpy(m))
    out.mean().backward()
    after = model.state_dict()
    assert out.shape == x.shape and out.grad_fn is not None
    for blk in ("enc1", "enc7", "dec4", "dec1"):
        assert not torch.equal(before[f"{blk}.bn.running_mean"], after[f"{blk}.bn.running_mean"])
        assert int(after[f"{blk}.bn.num_batches_tracked"]) == 1
        assert getattr(model, blk).input_conv.weight.grad is not None
        assert getattr(model, blk).mask_conv.weight.grad is None  # frozen
    holes = m == 0  # valid pixels still come from the input
    np.testing.assert_array_equal(out.detach().numpy()[~holes], (x * m)[~holes])


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_mode_forward_holds_float_rounding_on_one_thread(one_thread):
    """torch's CPU BatchNorm sums a channels-last batch's statistics in one
    float run per thread: on one thread G's train forward lay 5.9e-7 from
    its float64 run until the stages handed BatchNorm NCHW-contiguous
    batches (5.9e-8 since)."""
    torch.manual_seed(0)
    model = PConvUNet(8).train()
    x = torch.rand(4, 128, 128, 1)
    m = (torch.rand(4, 128, 128, 1) > 0.3).float()
    with torch.no_grad():
        got = model(x * m, m)
        want = copy.deepcopy(model).double()((x * m).double(), m.double())
    assert nrmse(got.double(), want) < 2e-7


def test_port_imports_no_jax():
    package = REPO / "terra_gan_tpu_torch"
    modules = sorted(
        "terra_gan_tpu_torch." + ".".join(p.relative_to(package).with_suffix("").parts)
        for p in package.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'cv2', 'yaml', 'matplotlib', 'terra_gan_tpu',\n"
        "        'requests', 'flask')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    try:  # inside the per-test limit (conftest.py), so a hang shows the child's stderr
        proc = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60,
        )
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"{e}:\n{(e.stderr or b'').decode(errors='replace')[-3000:]}")
    assert proc.returncode == 0, proc.stderr
    assert len(modules) >= 27
