"""The define-by-run layer kit on the card (`cuda` marker; skips without
a CUDA GPU and nvcc): `devices("gpu")` and placement, batches prefetched
from pinned memory, an optimizer's state saved and restored on the card,
and `chip_smoke.py`
phase 15 (the quickstart, MNIST CNN and char-RNN twins under
`enable_kernels()` with their K3, K4, K12, K14 and K15 launches held
exact; the quickstart network's, MnistCNN's, CharRNN's and the scan ops'
card route against the CPU's; every K3 and K4 call of those route checks
against its plain version; and the conv x optimizer sweep). This file
imports no JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import neuronika_tpu_torch as nk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    old = nk.config.device
    nk.config.device = "cuda"
    yield torch.device("cuda")
    nk.config.device = old


@pytest.mark.cuda
def test_cuda_devices_on_the_card(cuda):
    ds = nk.devices("gpu")
    assert len(ds) == torch.cuda.device_count()
    assert all(d.platform == "cuda" for d in ds)
    assert nk.default_device() == ds[0]
    v = nk.to_device(nk.from_ndarray(np.arange(3.0), device="cpu"), ds[0])
    assert nk.device_of(v).type == "cuda"
    assert nk.nn.Linear(3, 2).weight.device.type == "cuda"


@pytest.mark.cuda
def test_prefetch_to_the_card(cuda):
    from neuronika_tpu_torch import data

    recs = np.arange(30.0, dtype=np.float32).reshape(10, 3)
    labs = np.arange(10.0, dtype=np.float32).reshape(10, 1)
    ds = data.LabeledDataset(recs, labs)
    out = list(data.prefetch_to_device(ds.batch(4), size=2))
    assert len(out) == 3
    assert all(x.device.type == "cuda" and y.device.type == "cuda"
               for x, y in out)
    np.testing.assert_array_equal(torch.cat([x for x, _ in out]).cpu(),
                                  recs)
    np.testing.assert_array_equal(torch.cat([y for _, y in out]).cpu(),
                                  labs)


@pytest.mark.cuda
def test_optimizer_state_round_trip_on_the_card(cuda, tmp_path):
    from neuronika_tpu_torch import optim, utils

    def step(opt, p):
        loss = (p * p).sum()
        loss.forward()
        loss.backward(1.0)
        opt.step()
        opt.zero_grad()

    p = nk.from_ndarray(np.linspace(-1, 1, 12).reshape(4, 3),
                        dtype=torch.bfloat16).requires_grad()
    opt = optim.AMSGrad(0.1)
    opt.register(p)
    step(opt, p)
    utils.save_optimizer(str(tmp_path / "opt"), opt)
    q = nk.from_ndarray(p.data(), dtype=torch.bfloat16).requires_grad()
    resumed = optim.AMSGrad(0.1)
    resumed.register(q)
    utils.load_optimizer(str(tmp_path / "opt"), resumed)
    assert all(t.device.type == "cuda" and t.dtype == torch.bfloat16
               for t in resumed._state[0].values())
    step(opt, p)
    step(resumed, q)
    assert torch.equal(p.data(), q.data())


@pytest.mark.cuda
def test_layer_kit_on_the_card(cuda):
    sys.path.insert(0, ROOT)
    import chip_smoke as CS
    from neuronika_tpu_torch.ops import conv as C
    from neuronika_tpu_torch.ops import matmul as MM
    from neuronika_tpu_torch.ops import softmax as SM

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    launches = CS.phase_layer_kit(nk, C, MM, SM, card)
    assert all(launches[k] > 0 for k in CS.KIT_KERNELS)
