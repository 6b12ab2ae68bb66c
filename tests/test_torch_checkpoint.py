"""The port's checkpoint files against ``tikejax.utils.checkpoint``: the same
``.npz`` contract (nested dicts joined with '/', complex arrays as
``__re``/``__im`` float pairs, atomic replace), so a file that either
package writes loads in the other with the same keys, dtypes and values."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip(
    "torch", reason="the PyTorch port's tests need torch (the 'torch' extra)")

from tikejax.utils import checkpoint as jck
from tikejax_torch.utils import checkpoint as tck


def tree(rng):
    return {
        "psi": (rng.standard_normal((2, 5, 4))
                + 1j * rng.standard_normal((2, 5, 4))).astype(np.complex64),
        "ctl": {"budget": np.int64(7), "res": rng.random(3),
                "state": {"0": (rng.standard_normal(6)
                                + 1j * rng.standard_normal(6)),
                          "1": np.float32(0.25)}},
    }


def flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = (v.detach().cpu().numpy()
                               if torch.is_tensor(v) else np.asarray(v))
    return out


def assert_same_tree(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_load_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(0)
    t = tree(rng)
    path = str(tmp_path / "state.npz")
    if writer == "port":
        # The port saves tensors (and plain scalars) as they are.
        tck.save(path, {"psi": torch.from_numpy(t["psi"]), "ctl": t["ctl"]})
        loaded = jck.load(path)
    else:
        jck.save(path, {"psi": jnp.asarray(t["psi"]), "ctl": t["ctl"]})
        loaded = tck.load(path)
    assert_same_tree(loaded, t)
    with np.load(path) as z:
        assert {"psi__re", "psi__im", "ctl/state/0__re"} <= set(z.files)
    assert not os.path.exists(path + ".tmp")


def test_load_to_a_device_and_the_container_contract(tmp_path):
    rng = np.random.default_rng(1)
    t = tree(rng)
    path = str(tmp_path / "state.npz")
    tck.save(path, t)
    on_cpu = tck.load(path, device="cpu")
    assert torch.is_tensor(on_cpu["psi"]) and on_cpu["psi"].dtype == (
        torch.complex64)
    assert_same_tree(on_cpu, t)
    with pytest.raises(TypeError, match="dicts"):
        tck.save(path, {"x": [np.zeros(2)]})
    with pytest.raises(TypeError, match="root"):
        tck.save(path, [np.zeros(2)])
    with pytest.raises(ValueError, match="reserved"):
        tck.save(path, {"x__re": np.zeros(2)})
    with pytest.raises(ValueError, match="'/'"):
        tck.save(path, {"a/b": np.zeros(2)})
