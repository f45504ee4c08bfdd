"""Helpers of the image-model tests (``tests/test_torch_resnet*.py``,
``test_torch_inception.py``, ``test_torch_{train,serve}_resnet.py``):
flax variables with drawn BatchNorm values, per-leaf comparisons of
flax-layout trees, and a bound on torch's CPU threads."""

import jax
import numpy as np
import pytest
import torch


def drawn_batchnorm(params, batch_stats, seed):
    """numpy copies of flax ``params`` and ``batch_stats`` in which every
    BatchNorm scale, bias, mean and variance is drawn from ``seed``.
    flax zero-initialises the last scale of each block, which zeroes
    that branch and the gradient of every convolution behind it; drawn
    values let the parity tests see every convolution."""
    rng = np.random.default_rng(seed)

    def draw(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = draw(val)
                continue
            shape = np.shape(val)
            if key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
            elif key in ("bias", "mean"):
                out[key] = rng.normal(0.0, 0.1, shape).astype(np.float32)
            else:
                out[key] = np.asarray(val, np.float32)
        return out

    return draw(params), draw(batch_stats)


def nchw(x: np.ndarray) -> torch.Tensor:
    """An NHWC numpy batch as the port takes it: NCHW, channels_last."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def leaf_errors(got, want) -> dict:
    """``{path: max |got - want| / max |want|}`` over the leaves of two
    trees of the same structure."""
    errs = {}
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(got)):
        w, g = np.asarray(w), np.asarray(g)
        assert g.shape == w.shape, (jax.tree_util.keystr(path), g.shape,
                                    w.shape)
        errs[jax.tree_util.keystr(path)] = (
            float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30))
    return errs


def assert_trees_close(got, want, tol, what):
    """Same structure, and every leaf within ``tol`` of its largest |x|."""
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want)), what
    errs = leaf_errors(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, f"{what}: {worst} off by {errs[worst]}"


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two intra-op torch threads for a test module, restored after it.
    The CPU tests run in several worker processes at once, and with
    torch's default of a thread a core every parallel op then waits for
    descheduled threads: a small ResNet-18 run took 27 s against 1.2 s at
    two threads on a loaded 8-core host.  Test modules that train or
    serve an image model import it (autouse)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# The subprocesses the tests start read this at start-up, as above.
FEW_THREADS_ENV = {"OMP_NUM_THREADS": "2"}
