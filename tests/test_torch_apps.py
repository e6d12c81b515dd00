"""The paper's Test Case 2 (heterogeneous inference, Table 2) on the port
against the JAX reference.

The port's own copies of `make_dataset` and `train_weights` must give the
reference's arrays bit for bit (same numpy calls, same seeds), and the same
HiCR program must classify the test set the same way on every row: the
port's ``numpy`` row on its `hostcpu` backend and its ``torch`` and
``fused_linear`` rows on a CPU `torchdev` device (the plain versions; the
card runs the kernel in `chip_smoke.py`) give the reference's accuracy and
img-0 class, with img-0 scores within 1e-4 (`tests/test_paper_experiments.py`).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.apps import mlp_inference as jmlp  # noqa: E402
from repro.backends import hostcpu as jhostcpu  # noqa: E402
from repro_torch.apps import mlp_inference as tmlp  # noqa: E402
from repro_torch.backends import hostcpu, torchdev  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N_TEST = 1000


@pytest.fixture(scope="module")
def weights():
    return tmlp.train_weights()


@pytest.fixture(scope="module")
def reference(weights):
    cm = jhostcpu.HostComputeManager()
    res = jhostcpu.HostTopologyManager().query_topology().all_compute_resources()[0]
    return jmlp.run_inference(cm, res, kernel="numpy", weights=jmlp.train_weights(),
                              n_test=N_TEST)


def test_dataset_and_weights_equal_reference_bit_for_bit(weights):
    for n, seed in ((2000, 7), (N_TEST, 99), (4000, 11)):
        x, y = tmlp.make_dataset(n, seed=seed)
        jx, jy = jmlp.make_dataset(n, seed=seed)
        assert x.dtype == jx.dtype and y.dtype == jy.dtype
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    want = jmlp.train_weights()
    assert sorted(weights) == sorted(want)
    for k in want:
        assert weights[k].dtype == want[k].dtype and np.array_equal(weights[k], want[k]), k


def _run(kernel, weights):
    if kernel == "numpy":
        cm = hostcpu.HostComputeManager()
        res = hostcpu.HostTopologyManager().query_topology().all_compute_resources()[0]
    else:
        cm = torchdev.TorchComputeManager(device="cpu")
        res = torchdev.TorchTopologyManager(device="cpu").query_topology().all_compute_resources()[0]
    return tmlp.run_inference(cm, res, kernel=kernel, weights=weights, n_test=N_TEST)


@pytest.mark.parametrize("kernel", ["numpy", "torch", "fused_linear"])
def test_rows_match_reference_table2(weights, reference, kernel):
    ops.reset_launch_counts()
    got = _run(kernel, weights)
    assert got.backend == kernel
    assert got.accuracy == reference.accuracy > 0.85
    assert got.img0_class == reference.img0_class
    assert abs(got.img0_score - reference.img0_score) < 1e-4
    assert set(ops.launch_counts().values()) == {0}  # the CPU launches no kernel


def test_torch_rows_need_a_device_or_an_explicit_cpu(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kernel in ("torch", "fused_linear"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmlp.KERNELS[kernel](weights)
        out = tmlp.KERNELS[kernel](weights, "cpu")(tmlp.make_dataset(5, seed=1)[0])
        assert isinstance(out, np.ndarray) and out.shape == (5, tmlp.N_CLASSES)
