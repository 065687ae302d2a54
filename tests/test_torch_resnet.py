"""The port's ResNet (skypilot_tpu_torch/models/resnet.py) and its entry
point (train/train_resnet.py) against the JAX package's flax ResNet, on
the CPU.

ResNet18Thin on 4 random 32x32 images from a seed.  The flax variables
are drawn by ``model.init`` and then moved off their init (every norm's
scale, bias and running statistics drawn from a seed, so no branch is
zeroed and eval mode reads real statistics); the port gets them through
``resnet.params_from_flax``.  Tolerances, f32 (convolutions summed in
other orders by XLA and by torch, through 6 blocks and batch norms):
- logits, train and eval mode: atol 1e-4 (logits O(1));
- the loss: 1e-5; every gradient: atol GRAD_REL = 5e-3 of the leaf's
  largest gradient.  Batch norm's variance, E[x^2] - E[x]^2 in f32 as
  flax computes it, cancels, and its backward divides by it: measured
  against the same model in float64, each f32 side's gradients are off
  by up to 1e-3 of the leaf's largest (flax's as much as the port's), so
  the two sides differ by up to 1.2e-3 of it (a wrong padding, momentum
  or variance moves them by 1e-1 or more);
- one SGD-momentum step against optax.sgd(0.1, momentum=0.9): the loss
  at 1e-5, each parameter's update at GRAD_REL of the leaf's largest,
  the running statistics at STATS_ATOL; a second update from flax's
  second gradients (through the momentum trace) at GRAD_REL too;
- bf16 convolutions: logits within BF16_REL = 0.035 of the largest
  logit (3.8 here, 0.83 on average: 0.133).  Each convolution rounds its
  inputs and output to bf16, 2^-8 relative, on both sides, whose bf16
  roundings land on different sums: the two differ by 0.049, while
  flax's bf16 logits differ from its own f32 ones by 0.20.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from skypilot_tpu.models import resnet as j_resnet  # noqa: E402
from skypilot_tpu_torch.models import resnet  # noqa: E402
from skypilot_tpu_torch.train import train_resnet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4
GRAD_REL = 5e-3
STATS_ATOL = 1e-4
BF16_REL = 0.035


def _images(n=4, size=32, seed=0):
    return np.random.RandomState(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _labels(n=4):
    return np.arange(n, dtype=np.int32) % 10


def _flax(dtype=jnp.float32, seed=0):
    """(flax module, numpy variables moved off their init)."""
    model = j_resnet.ResNet18Thin(dtype=dtype)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(_images()),
                           train=True)
    rng = np.random.RandomState(seed)

    def move(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        noise = rng.normal(size=x.shape).astype(np.float32)
        if name == 'scale':
            return 1 + 0.2 * noise
        if name in ('bias', 'mean'):
            return 0.1 * noise
        if name == 'var':
            return 1 + 0.5 * np.abs(noise)
        return x
    return model, jax.tree_util.tree_map_with_path(move, variables)


def _port(variables, dtype=torch.float32):
    model = resnet.ResNet18Thin(dtype=dtype)
    model.load_state_dict(resnet.params_from_flax(variables))
    return model


@pytest.mark.parametrize('size,k,stride', [(112, 3, 2), (7, 3, 2),
                                           (56, 3, 1), (56, 1, 2),
                                           (9, 7, 2)])
def test_same_padding_is_lax(size, k, stride):
    assert resnet._same_pads(size, k, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (k,), (stride,), 'SAME')[0])


def test_state_dict_names_cover_the_flax_tree():
    _, variables = _flax()
    got = resnet.params_from_flax(variables)
    assert set(got) == set(_port(variables).state_dict())
    kernel = variables['params']['ResNetBlock_1']['Conv_1']['kernel']
    assert got['ResNetBlock_1.Conv_1.kernel'].shape == (
        kernel.shape[3], kernel.shape[2], kernel.shape[0], kernel.shape[1])


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_forward_matches_flax(train):
    model, variables = _flax()
    port = _port(variables).train(train)
    x = _images()
    if train:
        want, updates = model.apply(variables, jnp.asarray(x), train=True,
                                    mutable=['batch_stats'])
    else:
        want = model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    if train:   # the running statistics moved as flax's did
        want_stats = resnet.params_from_flax(
            {'params': {}, 'batch_stats': updates['batch_stats']})
        state = port.state_dict()
        for name, w in want_stats.items():
            np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                       atol=1e-6, rtol=1e-6, err_msg=name)


def _flax_loss(model, params, batch_stats, x, y):
    logits, updates = model.apply(
        {'params': params, 'batch_stats': batch_stats}, x, train=True,
        mutable=['batch_stats'])
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
    return loss, updates['batch_stats']


def test_loss_and_every_gradient_match_flax():
    model, variables = _flax()
    x, y = _images(), _labels()
    (loss, _), grads = jax.value_and_grad(
        lambda p: _flax_loss(model, p, variables['batch_stats'],
                             jnp.asarray(x), jnp.asarray(y)),
        has_aux=True)(variables['params'])
    port = _port(variables)
    got = torch.nn.functional.cross_entropy(
        port(torch.from_numpy(x)), torch.from_numpy(y).long())
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), atol=1e-5,
                               rtol=0)
    want = resnet.params_from_flax({'params': grads})
    params = dict(port.named_parameters())
    assert set(params) == set(want)
    for name, w in want.items():
        g = params[name].grad
        assert float(g.abs().max()) > 0, name
        _close_to_leaf(g, w, name)


def _close_to_leaf(got, want, name):
    """Elementwise within GRAD_REL of the largest element of `want`."""
    np.testing.assert_allclose(
        got.numpy(), want.numpy(), rtol=0,
        atol=GRAD_REL * float(want.abs().max()), err_msg=name)


def test_sgd_momentum_steps_match_optax():
    """One step of train_resnet's step (forward in train mode, loss,
    gradients, optax.sgd(0.1, momentum=0.9)'s update) against flax and
    optax: the loss, every parameter's update and the running statistics
    after it.  Then a second update from flax's second gradients, which
    goes through the momentum trace the first step left."""
    model, variables = _flax()
    x, y = _images(), _labels()
    tx = optax.sgd(0.1, momentum=0.9)
    params, stats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)
    grads = []
    for i in range(2):
        (loss, new_stats), g = jax.value_and_grad(
            lambda p: _flax_loss(model, p, stats, jnp.asarray(x),
                                 jnp.asarray(y)), has_aux=True)(params)
        updates, opt_state = tx.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        grads.append(g)
        if i == 0:
            want_loss, stats = float(loss), new_stats
            after_one = resnet.params_from_flax({'params': params,
                                                 'batch_stats': stats})
    port = _port(variables)
    optimizer = train_resnet.sgd(port)
    step = train_resnet.make_step(port, optimizer)
    got = float(step(torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_allclose(got, want_loss, atol=1e-5, rtol=0)
    start = resnet.params_from_flax(variables)
    state = port.state_dict()
    assert set(state) == set(after_one)
    for name, w in after_one.items():
        if name.endswith(('.mean', '.var')):
            np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                       atol=STATS_ATOL, rtol=0,
                                       err_msg=name)
        else:
            _close_to_leaf(state[name] - start[name], w - start[name], name)
    second = resnet.params_from_flax({'params': grads[1]})
    for name, p in port.named_parameters():
        p.grad = second[name].clone()
    optimizer.step()
    want = resnet.params_from_flax({'params': params})
    state = port.state_dict()
    for name, w in want.items():
        _close_to_leaf(state[name] - start[name], w - start[name], name)


def test_bf16_convolutions_match_flax():
    model, variables = _flax(jnp.bfloat16)
    port = _port(variables, torch.bfloat16)
    x = _images()
    want, _ = model.apply(variables, jnp.asarray(x), train=True,
                          mutable=['batch_stats'])
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in port.parameters())
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


def test_train_resnet_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    proc = subprocess.run(
        [sys.executable, '-m', 'skypilot_tpu_torch.train.train_resnet',
         '--device', 'cpu', '--steps', '2', '--batch-size', '2',
         '--image-size', '32'], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith('images/sec: '), last
    assert np.isfinite(float(last.split('final loss ')[1]))
