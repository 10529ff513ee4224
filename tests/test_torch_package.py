"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import context, nd, sym
from mxnet_tpu_torch.models import transformer as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "mxnet_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "mxnet_tpu"}


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "torch_lm_breakdown.py"),
             os.path.join(REPO, "tools", "torch_lm_train_breakdown.py"),
             os.path.join(REPO, "tools", "torch_flash_bwd_cpu_model.py"),
             os.path.join(REPO, "tools", "torch_lm_cpu_spread.py"),
             os.path.join(REPO, "tools", "torch_mlp_breakdown.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_import_leaves_no_jax_in_a_clean_process():
    code = ("import sys, mxnet_tpu_torch, mxnet_tpu_torch.models, "
            "mxnet_tpu_torch.ops._build, mxnet_tpu_torch.ndarray, "
            "mxnet_tpu_torch.symbol, mxnet_tpu_torch.executor, "
            "mxnet_tpu_torch.rtc, mxnet_tpu_torch.optimizer, "
            "mxnet_tpu_torch.initializer, mxnet_tpu_torch.parallel.zero; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r))" % (sorted(FORBIDDEN),))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    assert os.path.basename(path) != "torch.py"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_context_raises_without_cuda(no_cuda):
    for resolve in (mt.current_context, context.as_device,
                    lambda: mt.gpu(0), lambda: context.as_device("cuda")):
        with pytest.raises(mt.MXNetError):
            resolve()


@pytest.mark.parametrize("entry", ["init", "from_jax"])
def test_entry_point_without_device_raises_without_cuda(no_cuda, entry):
    cfg = tt.TransformerLMConfig(vocab=8, d_model=8, n_heads=2, d_ff=8,
                                 n_layers=1, max_len=4)
    with pytest.raises(mt.MXNetError):
        if entry == "init":
            tt.init_transformer_params(torch.Generator(), cfg)
        else:
            np_params = {n: np.zeros(s, np.float32)
                         for n, s in tt._param_shapes(cfg).items()}
            tt.params_from_jax(np_params, cfg)


@pytest.mark.parametrize("device", ["cpu", "cpu:0", torch.device("cpu")])
def test_explicit_cpu_resolves(device):
    assert context.as_device(device) == torch.device("cpu") \
        == mt.cpu().torch_device
    assert context.as_context(device) == mt.cpu() == mt.Context("cpu", 0)


def _raise_without_device(entry):
    """Call one entry point of the substrate without naming a device."""
    x = np.zeros((2, 3), np.float32)
    if entry == "nd.array":
        nd.array(x)
    elif entry == "nd.zeros":
        nd.zeros((2, 3))
    elif entry == "simple_bind":
        sym.FullyConnected(sym.Variable("data"), num_hidden=2).simple_bind(
            None, data=(2, 3))
    elif entry == "bind_gpu":
        sym.Variable("d").bind(mt.Context("gpu", 0),
                               {"d": nd.array(x, ctx=mt.cpu())})
    elif entry == "rtc_op":
        mt.rtc.register("pl_nodevice", lambda: torch.zeros(1))
        try:
            nd.pl_nodevice()
        finally:
            mt.rtc.unregister("pl_nodevice")
    elif entry == "generator":
        mt.random.generator()
    elif entry == "scoped_gpu":
        with mt.Context("gpu", 0):
            nd.ones((1,))


@pytest.mark.parametrize("entry", ["nd.array", "nd.zeros", "simple_bind",
                                   "bind_gpu", "rtc_op", "generator",
                                   "scoped_gpu"])
def test_substrate_entry_point_without_device_raises(no_cuda, entry):
    with pytest.raises(mt.MXNetError):
        _raise_without_device(entry)


def test_cpu_scope_sets_the_default_context(no_cuda):
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
        assert nd.array([1.0]).context == mt.cpu()
        with mt.Context("cpu", 0):
            assert mt.current_context() == mt.cpu()
        assert mt.current_context() == mt.cpu()
    with pytest.raises(mt.MXNetError):
        mt.current_context()


def test_unsupported_device_raises():
    with pytest.raises(mt.MXNetError):
        context.as_device("meta")
