"""The port's ``StereoLoader`` and the loop's prefetcher against the JAX
package's (CPU, no model).

A batch is a pure function of (seed, epoch, indices), so the port's
batches must equal the JAX package's bit for bit under every worker
flavor, after ``set_state`` and ``add_salt``; the fault isolation
(retry, quarantine with content keys, respawn of a killed process worker)
and the prefetcher's terminal states mirror tests/test_train_resilience.py
and tests/test_data.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.data import loader as jloader
from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.data import datasets as tds
from raft_stereo_tpu_torch.data import loader as tloader
from raft_stereo_tpu_torch.data.loader import (LoaderBroken, StereoLoader,
                                               _substitute_index,
                                               sample_content_key)
from raft_stereo_tpu_torch.training.train_loop import (_DevicePrefetcher,
                                                       _Upload, compact)
from torch_train_support import make_sceneflow_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (32, 64)
BATCH = 4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_sceneflow_train(str(tmp_path_factory.mktemp("sf")), n=4)


def _train_cfg(cls):
    return cls(batch_size=BATCH, image_size=CROP, seed=7)


@pytest.fixture(scope="module")
def jax_batches(tree):
    """JAX's two epochs of the tiny SceneFlow mixture, sync workers."""
    ds = jds.build_training_mixture(_train_cfg(JaxTrainConfig), tree)
    return list(jloader.StereoLoader(ds, batch_size=BATCH, num_workers=0,
                                     seed=7, epochs=2))


def _port_loader(tree, **kw):
    ds = tds.build_training_mixture(_train_cfg(TrainConfig), tree)
    return StereoLoader(ds, batch_size=BATCH, seed=7, epochs=2, **kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("workers", [
    dict(num_workers=0), dict(num_workers=3),
    dict(num_workers=2, worker_type="process")],
    ids=["sync", "thread", "process"])
def test_batches_bit_equal_to_jax(tree, jax_batches, workers):
    batches = list(_port_loader(tree, **workers))
    _assert_batches_equal(batches, jax_batches)
    assert batches[0]["image1"].shape == (BATCH,) + CROP + (3,)
    assert batches[0]["image1"].dtype == np.uint8


@pytest.mark.parametrize("state", [
    {"offset": 5, "salts": []},
    {"offset": 3, "salts": [[0, 3, 1]]},
    {"offset": 9, "salts": [[0, 3, 2], [1, 1, 5]]}])
def test_set_state_and_salts_match_jax(tree, state):
    jds_ = jds.build_training_mixture(_train_cfg(JaxTrainConfig), tree)
    want_loader = jloader.StereoLoader(jds_, batch_size=BATCH,
                                       num_workers=0, seed=7, epochs=2)
    want_loader.set_state(state)
    got_loader = _port_loader(tree, num_workers=2)
    got_loader.set_state(state)
    _assert_batches_equal(list(got_loader), list(want_loader))
    assert got_loader.state(consumed=2) == want_loader.state(consumed=2)


class _Fault:
    """Deterministic samples; ``bad`` raise always, ``flaky`` on the first
    decode only (tests/test_train_resilience.py's dataset)."""

    def __init__(self, n=8, bad=(), flaky=()):
        self.n = n
        self.bad = set(bad)
        self.flaky = dict.fromkeys(flaky, 0)

    def __len__(self):
        return self.n

    def __getitem__(self, i, epoch=0):
        if i in self.bad:
            raise ValueError(f"corrupt sample {i}")
        if i in self.flaky and self.flaky[i] == 0:
            self.flaky[i] += 1
            raise ValueError(f"flaky sample {i}")
        return {"x": np.full((2, 2), float(i) + 100.0 * epoch)}


def _values(loader):
    return [b["x"][:, 0, 0].tolist() for b in loader]


@pytest.mark.parametrize("kw", [
    dict(shuffle=False, epochs=1),
    dict(seed=7, epochs=2),
    dict(seed=7, epochs=2, num_workers=2)])
def test_orders_match_jax(kw):
    for add_salt in (False, True):
        loaders = [mod.StereoLoader(_Fault(16), batch_size=2,
                                    **{"num_workers": 0, **kw})
                   for mod in (tloader, jloader)]
        if add_salt:
            for ld in loaders:
                ld.set_state({"offset": 3, "salts": []})
                ld.add_salt(0, 3, 1)
        got, want = (_values(ld) for ld in loaders)
        assert got == want


def test_salt_reshuffles_only_the_rest_of_the_epoch():
    def mk():
        return StereoLoader(_Fault(16), batch_size=2, num_workers=0, seed=7,
                            epochs=1)
    base = _values(mk())
    salted = mk()
    salted.set_state({"offset": 3, "salts": [[0, 3, 1]]})
    tail = _values(salted)
    flat_base = [v for b in base[3:] for v in b]
    flat_tail = [v for b in tail for v in b]
    assert sorted(flat_base) == sorted(flat_tail) and flat_base != flat_tail


def test_quarantine_substitute_and_payload_match_jax(tmp_path):
    got, want = [], []
    for mod, out in ((tloader, got), (jloader, want)):
        qp = str(tmp_path / f"{mod.__name__}.json")
        ld = mod.StereoLoader(_Fault(bad=(3,)), batch_size=2, num_workers=0,
                              shuffle=False, epochs=1, quarantine_path=qp)
        out.append(_values(ld))
        out.append(dict(ld.stats))
        out.append(ld.quarantined)
        with open(qp) as f:
            out.append(json.load(f))
    assert got == want
    assert got[0] == [[0.0, 1.0], [2.0, 4.0], [4.0, 5.0], [6.0, 7.0]]
    assert got[3]["version"] == 2
    # a fresh loader starts from the persisted list, with no new quarantine
    again = StereoLoader(_Fault(bad=(3,)), batch_size=2, num_workers=0,
                         shuffle=False, epochs=1,
                         quarantine_path=str(tmp_path / f"{tloader.__name__}"
                                                          ".json"))
    assert again.quarantined == {3}
    assert _values(again) == got[0] and again.stats["quarantined"] == 0


def test_legacy_quarantine_file_migrates(tmp_path):
    qp = str(tmp_path / "q.json")
    with open(qp, "w") as f:
        json.dump({"indices": [3]}, f)
    loader = StereoLoader(_Fault(bad=(3,)), batch_size=2, num_workers=0,
                          shuffle=False, epochs=1, quarantine_path=qp)
    assert loader.quarantined == {3}
    with open(qp) as f:
        payload = json.load(f)
    assert payload["version"] == 2
    assert [e["index"] for e in payload["samples"]] == [3]


def test_quarantine_content_key_survives_relisting(tmp_path):
    class _Files(_Fault):
        def __init__(self, files, **kw):
            super().__init__(n=len(files), **kw)
            self.files = list(files)

        def sample_paths(self, i):
            return (self.files[i],)

    files = []
    for i in range(8):
        p = tmp_path / f"s{i}.bin"
        p.write_bytes(bytes([i]) * (i + 1))
        files.append(str(p))
    qp = str(tmp_path / "q.json")
    ds = _Files(files, bad=(3,))
    list(StereoLoader(ds, batch_size=2, num_workers=0, shuffle=False,
                      epochs=1, quarantine_path=qp))
    key3 = sample_content_key(ds, 3)
    assert key3 == jloader.sample_content_key(ds, 3)
    with open(qp) as f:
        assert json.load(f)["samples"] == [{"index": 3, "key": key3}]
    extra = tmp_path / "s_new.bin"
    extra.write_bytes(b"xx" * 9)
    moved = StereoLoader(_Files([str(extra)] + files, bad=(4,)),
                         batch_size=2, num_workers=0, shuffle=False,
                         epochs=1, quarantine_path=qp)
    assert moved.quarantined == {4}
    with open(files[3], "ab") as f:
        f.write(b"repaired")
    fixed = StereoLoader(_Files(files), batch_size=2, num_workers=0,
                         shuffle=False, epochs=1, quarantine_path=qp)
    assert fixed.quarantined == set()


def test_retry_succeeds_without_quarantine():
    loader = StereoLoader(_Fault(flaky=(5,)), batch_size=2, num_workers=0,
                          shuffle=False, epochs=1)
    assert _values(loader)[2] == [4.0, 5.0]
    assert loader.stats == {"retried": 1, "quarantined": 0,
                            "worker_respawns": 0}


def test_fault_isolation_off_propagates():
    loader = StereoLoader(_Fault(bad=(3,)), batch_size=2, num_workers=0,
                          shuffle=False, epochs=1, fault_isolation=False)
    with pytest.raises(ValueError, match="corrupt sample 3"):
        list(loader)


def test_all_quarantined_is_typed():
    with pytest.raises(LoaderBroken, match="quarantined"):
        _substitute_index(0, 4, {0, 1, 2, 3})


def test_killed_process_worker_is_respawned(tmp_path):
    import procworker_support as sup   # importable by spawned children

    marker = str(tmp_path / "killed.marker")
    loader = StereoLoader(sup.KillOnceDataset(marker, kill_index=5),
                          batch_size=2, num_workers=2, shuffle=False,
                          epochs=1, worker_type="process")
    assert _values(loader) == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0],
                               [6.0, 7.0]]
    assert loader.stats["worker_respawns"] >= 1
    assert os.path.exists(marker)


def test_data_modules_import_no_torch():
    """Spawned decode workers import the dataset's module: the loader and
    the data modules it pulls in must not import torch."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import raft_stereo_tpu_torch.data.loader\n"
            "import raft_stereo_tpu_torch.data.datasets\n"
            "print('torch' in sys.modules)" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120).stdout.strip()
    assert out == "False"


# ------------------------------------------------------------- prefetcher
def test_prefetcher_reraises_and_stays_terminal():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("upload died")

    pf = _DevicePrefetcher(gen(), put=lambda x: x * 10, depth=1)
    assert next(pf) == 10 and next(pf) == 20
    for _ in range(2):    # the second call must not block on the queue
        with pytest.raises(RuntimeError, match="upload died"):
            next(pf)
    pf.close(timeout=2.0)
    assert not pf._thread.is_alive()


def test_prefetcher_put_exception_surfaces():
    def bad_put(x):
        raise ValueError("upload failed")

    pf = _DevicePrefetcher(iter([1, 2, 3]), put=bad_put, depth=1)
    for _ in range(2):
        with pytest.raises(ValueError, match="upload failed"):
            next(pf)
    pf.close(timeout=2.0)
    assert not pf._thread.is_alive()


def test_prefetcher_exhaustion_is_sticky_and_close_joins():
    pf = _DevicePrefetcher(iter([1]), put=lambda x: x, depth=1)
    assert next(pf) == 1
    assert next(pf, None) is None
    assert next(pf, None) is None
    pf.close(timeout=2.0)
    assert not pf._thread.is_alive()
    assert pf.wait_s >= 0.0


def test_prefetcher_close_releases_a_blocked_producer():
    """A producer blocked on a full queue leaves at ``close`` and the
    wrapped generator is closed (its ``finally`` runs)."""
    closed = []

    def gen():
        try:
            for i in range(100):
                yield i
        finally:
            closed.append(True)

    pf = _DevicePrefetcher(gen(), put=lambda x: x, depth=1)
    assert next(pf) == 0
    pf.close(timeout=2.0)
    assert not pf._thread.is_alive() and closed == [True]


def test_upload_on_the_cpu_wraps_and_compacts(tree):
    batch = next(iter(_port_loader(tree, num_workers=0)))
    up = _Upload(torch.device("cpu"), compact_upload=True)
    got = up.take(up.put(batch))
    assert got["flow"].dtype == torch.float16
    assert got["valid"].dtype == torch.uint8
    assert got["image1"].dtype == torch.uint8
    np.testing.assert_array_equal(got["flow"].numpy(),
                                  batch["flow"].astype(np.float16))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  (batch["valid"] > 0.5).astype(np.uint8))
    plain = _Upload(torch.device("cpu"), compact_upload=False)
    assert plain.take(plain.put(batch))["flow"].dtype == torch.float32
    assert compact(batch)["flow"].dtype == np.float16
