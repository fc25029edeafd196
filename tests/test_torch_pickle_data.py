"""The port's pickle datasets, factory, batcher and the daemon's airfoil
switches against the JAX package, on the CPU.

Tiny trajectories are written in the DeepMind MeshGraphNets pickle layout
(``mesh_pos``, ``cells``, ``velocity`` (T, N, 2), ``pressure`` (T, N, 1),
``density``), as ``tests/test_data.py:106-162`` writes them: the cylinder
mesh generator's meshes, and for the airfoil a mesh stretched beyond the
crop box on every side with fields in the airfoil's physical units.  The
JAX side locates pixels with its NumPy locator (the port's only one;
matplotlib's trifinder may differ on pixels exactly on an edge), set with
monkeypatch.  Tolerances: samples within 1e-6 absolute (the same f32
resample and normalisation; the three barycentric terms summed in another
order), except the airfoil's pressure channel: its raw values are ~1e5,
whose f32 spacing (2^-7) over the std 6197 is 1.26e-6 in normalised units,
so it is held to 4 such spacings (5.0e-6); masked airfoil pixels exactly
0; threaded batches equal to serial ones bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from fluid_llm_tpu.config import Config as JConfig
from fluid_llm_tpu.core import triangulation as jtri
from fluid_llm_tpu.data import get_dataset as jget_dataset
from fluid_llm_tpu.data.airfoil import AirfoilDataset as JAirfoil
from fluid_llm_tpu.data.airfoil import crop_mesh as jcrop_mesh
from fluid_llm_tpu.data.cylinder import MGNDataset as JMGN
from fluid_llm_tpu.data.pipeline import make_batches as jmake_batches
from fluid_llm_tpu.tools import serve as jsrv
from fluid_llm_tpu_torch.config import Config
from fluid_llm_tpu_torch.core.interp import resample_to_grid
from fluid_llm_tpu_torch.data import get_dataset, make_batches
from fluid_llm_tpu_torch.data.airfoil import AirfoilDataset, crop_mesh, natural_key
from fluid_llm_tpu_torch.data import cylinder
from fluid_llm_tpu_torch.data.cylinder import MGNDataset
from fluid_llm_tpu_torch.data.pipeline import PatchDataset
from fluid_llm_tpu_torch.data.synthetic import analytic_flow, make_cylinder_mesh
from fluid_llm_tpu_torch.tools import serve as srv

torch.set_num_threads(2)

STEPS = 600  # the pickles' length: training windows start anywhere in [0, 600 - seq_len]


def write_trajectories(folder, n: int, airfoil: bool = False, steps: int = STEPS,
                       start: int = 0) -> None:
    """``n`` trajectories ``save_<start+i>.pkl`` in the MGN pickle layout."""
    folder.mkdir(parents=True, exist_ok=True)
    for i in range(start, start + n):
        if airfoil:  # x in (-0.8, 3.2), y in (-1, 1.05): the crop bites on every side
            pos, faces = make_cylinder_mesh(70 + i, 30, 24)
            pos = pos * np.array([2.5, 5.0]) + np.array([-0.8, -1.0])
        else:
            pos, faces = make_cylinder_mesh(50 + i, 24, 10)
        states = analytic_flow(pos, steps, 50 + i)  # (T, 3, N)
        if airfoil:
            states = (states * np.array([50.0, 50.0, 6000.0]).reshape(1, 3, 1)
                      + np.array([170.0, 0.0, 9.9e4]).reshape(1, 3, 1)).astype(np.float32)
        data = {
            "mesh_pos": pos.astype(np.float32),
            "cells": faces.astype(np.int64 if airfoil else np.int32),
            "velocity": states[:, :2].transpose(0, 2, 1),
            "pressure": states[:, 2:].transpose(0, 2, 1),
            "density": np.ones((steps, len(pos), 1), np.float32),
        }
        with open(folder / f"save_{i}.pkl", "wb") as f:
            pickle.dump(data, f)


@pytest.fixture
def numpy_locator(monkeypatch):
    monkeypatch.setattr(jtri, "locate_triangles", jtri._locate_numpy)


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    root = tmp_path_factory.mktemp("pickles")
    write_trajectories(root / "cylinder_dataset" / "train", 5)
    write_trajectories(root / "cylinder_dataset" / "valid", 2)
    write_trajectories(root / "airfoil_dataset" / "valid", 2, airfoil=True)
    # names that sort differently as text and naturally: 2, 10
    write_trajectories(root / "airfoil_dataset" / "train", 1, airfoil=True, start=2)
    write_trajectories(root / "airfoil_dataset" / "train", 1, airfoil=True, start=10)
    return root


AIRFOIL_P_ATOL = 4 * float(np.spacing(np.float32(1e5))) / 6197.0


def _assert_samples_equal(got, want, exact_zero_mask: bool = False):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        g, w = g.numpy(), np.asarray(w)
        if exact_zero_mask and g.dtype == np.float32:  # channel 2: the airfoil's pressure
            np.testing.assert_allclose(g[..., :2, :, :], w[..., :2, :, :], atol=1e-6)
            np.testing.assert_allclose(g[..., 2, :, :], w[..., 2, :, :], atol=AIRFOIL_P_ATOL)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6)
    if exact_zero_mask:  # masked normalisation: outside-mesh and padded pixels exactly 0
        for states in (got[0], got[1], got[2]):
            assert torch.all(states[got[3]] == 0)


@pytest.mark.parametrize("kind", ["cylinder", "airfoil"])
@pytest.mark.parametrize("step_num", [None, 37])
def test_pickle_dataset_samples_match_jax(pickles, numpy_locator, kind, step_num):
    """``MGNDataset`` / ``AirfoilDataset`` samples (valid split: window at
    step 100, or a given ``step_num``), all five tensors, and ``ds_props``:
    the airfoil's crop re-indexing, flip, trimmed patch count and masked
    normalisation included."""
    folder = str(pickles / f"{kind}_dataset" / "valid")
    cls, jcls = (AirfoilDataset, JAirfoil) if kind == "airfoil" else (MGNDataset, JMGN)
    ds = cls(folder, resolution=64, seq_len=4, mode="valid")
    jds = jcls(folder, resolution=64, seq_len=4, mode="valid")
    assert vars(ds.ds_props()) == vars(jds.ds_props())
    if kind == "airfoil":
        full = MGNDataset(folder, resolution=64, seq_len=4, mode="valid")
        assert ds.N_x_patch >= 1 and ds.N_y_patch >= 1
        assert full.ds_props().Nx_patch != ds.N_x_patch  # cropped and trimmed
    for idx in range(len(ds)):
        _assert_samples_equal(ds.sample(idx, step_num), jds.sample(idx, step_num),
                              exact_zero_mask=kind == "airfoil")


def test_crop_mesh_and_natural_order_match_jax(pickles):
    pos, faces = make_cylinder_mesh(71, 30, 24)
    pos = pos * np.array([2.5, 5.0]) + np.array([-0.8, -1.0])
    fields = [np.random.default_rng(0).normal(size=(3, len(pos), 2)).astype(np.float32)]
    got, want = crop_mesh(pos, faces.astype(np.int64), fields), \
        jcrop_mesh(pos, faces.astype(np.int64), fields)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2][0], want[2][0])
    assert 0 < len(got[0]) < len(pos)
    train = str(pickles / "airfoil_dataset" / "train")
    assert AirfoilDataset(train, resolution=64, seq_len=4).save_files == \
        JAirfoil(train, resolution=64, seq_len=4).save_files == ["save_2.pkl", "save_10.pkl"]
    assert sorted(["a10", "a2", "b1"], key=natural_key) == ["a2", "a10", "b1"]


@pytest.mark.parametrize("name", ["cylinder", "airfoil", "mgn", "synthetic:3", "synthetic",
                                  "other"])
def test_get_dataset_routes_as_jax(pickles, monkeypatch, name):
    """``airfoil``/``*airfoil*``, ``cylinder``/``*cylinder*``/``./ds/MGN*``,
    ``synthetic[:n]``; anything else raises on both sides."""
    monkeypatch.chdir(pickles)
    load_dir = {"cylinder": str(pickles / "cylinder_dataset"),
                "airfoil": str(pickles / "airfoil_dataset"),
                "mgn": "./ds/MGN/set"}.get(name, name)
    if name == "mgn":
        write_trajectories(pickles / "ds" / "MGN" / "set" / "valid", 1, steps=110)
    kw = dict(load_dir=load_dir, resolution=64, autoreg_seq_len=4)
    if name == "other":
        for factory, cfg in ((get_dataset, Config(**kw)), (jget_dataset, JConfig(**kw))):
            with pytest.raises(ValueError, match="Invalid dataset"):
                factory(cfg, mode="valid")
        return
    ds, jds = get_dataset(Config(**kw), mode="valid"), jget_dataset(JConfig(**kw), mode="valid")
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds)
    assert vars(ds.ds_props()) == vars(jds.ds_props())


def test_threaded_batches_equal_serial(pickles):
    """Training batches (shuffled, window starts drawn) from 3 worker threads
    equal the serial ones bit for bit, and the serial ones equal the JAX
    package's serial batches (its draws happen in the same order)."""
    folder = str(pickles / "cylinder_dataset" / "train")
    kw = dict(resolution=64, seq_len=4, mode="train")
    runs = {}
    for workers in (0, 3):
        runs[workers] = list(make_batches(MGNDataset(folder, **kw), 2, shuffle=True, seed=4,
                                          num_workers=workers))
    assert len(runs[0]) == len(runs[3]) == 3
    for b0, b3 in zip(runs[0], runs[3]):
        for a, b in zip(b0, b3):
            assert torch.equal(a, b)
    jbatches = list(jmake_batches(JMGN(folder, **kw), 2, shuffle=True, seed=4))
    for b0, jb in zip(runs[0], jbatches):
        for a, b in zip(b0, jb):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_threaded_batches_equal_serial_when_the_cache_evicts(pickles, monkeypatch):
    """With a cache of 2 trajectories for 5, most samples rebuild theirs
    (evicted meanwhile, or in construction on another thread); batches from
    4 threads still equal the serial ones bit for bit."""
    monkeypatch.setattr(cylinder, "MAX_CACHE", 2)
    folder = str(pickles / "cylinder_dataset" / "train")
    kw = dict(resolution=64, seq_len=4, mode="train")
    serial, threaded = (list(make_batches(MGNDataset(folder, **kw), 1, shuffle=True, seed=9,
                                          num_workers=w)) for w in (0, 4))
    assert len(serial) == len(threaded) == 5
    for b0, b4 in zip(serial, threaded):
        for a, b in zip(b0, b4):
            assert torch.equal(a, b)


class _Stub(PatchDataset):
    """A dataset whose trajectories are built by ``build``."""

    def __init__(self, build, limit=None):
        super().__init__(resolution=8, patch_size=(4, 4), seq_len=2)
        self.build, self.limit, self.built = build, limit, []

    def get_trajectory(self, idx):
        return self.cached_trajectory(idx, self._count, self.limit)

    def _count(self, idx):
        self.built.append(idx)
        return self.build(idx)


def test_trajectory_cache_builds_side_by_side_and_once():
    """The cache's lock is not held while a trajectory is built: two threads
    building two trajectories meet inside their builds (a barrier of 2 that
    would time out if one waited for the other); a trajectory asked for by
    four threads at once is built once and all get the same object; a
    build that raises is not cached; at most ``limit`` are kept, the oldest
    evicted first."""
    from concurrent.futures import ThreadPoolExecutor
    import threading

    barrier = threading.Barrier(2, timeout=10)

    def meet(idx):
        barrier.wait()
        return ("traj", idx)

    ds = _Stub(meet)
    with ThreadPoolExecutor(2) as pool:
        assert list(pool.map(ds.get_trajectory, [0, 1])) == [("traj", 0), ("traj", 1)]

    gate = threading.Event()

    def slow(idx):
        gate.wait(10)
        return object()

    ds = _Stub(slow)
    with ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(ds.get_trajectory, 3) for _ in range(4)]
        gate.set()
        got = [f.result() for f in futures]
    assert ds.built == [3] and all(g is got[0] for g in got)

    calls = []

    def flaky(idx):
        calls.append(idx)
        if len(calls) == 1:
            raise OSError("unreadable")
        return ("traj", idx)

    ds = _Stub(flaky)
    with pytest.raises(OSError):
        ds.get_trajectory(5)
    assert ds.get_trajectory(5) == ("traj", 5) and calls == [5, 5]

    ds = _Stub(lambda idx: ("traj", idx), limit=3)
    for idx in (0, 1, 2, 3, 2, 0):
        ds.get_trajectory(idx)
    assert ds.built == [0, 1, 2, 3, 0]  # 0 evicted by 3, 2 still kept, 1 evicted by 0
    assert sorted(ds._cache) == [0, 2, 3]


def test_serial_valid_batches_match_jax(pickles, numpy_locator):
    folder = str(pickles / "airfoil_dataset" / "valid")
    kw = dict(resolution=64, seq_len=4, mode="valid")
    got = list(make_batches(AirfoilDataset(folder, **kw), 2, shuffle=False))
    want = list(jmake_batches(JAirfoil(folder, **kw), 2, shuffle=False))
    assert len(got) == len(want) == 1
    _assert_samples_equal(got[0], want[0], exact_zero_mask=True)


def _bare_engine(cls, ds, **extra):
    """An engine's geometry without a model: what ``build_batch`` and
    ``_to_client_grid`` read."""
    eng = cls.__new__(cls)
    eng.dataset = ds
    eng.pad_x, eng.pad_y, eng.nx, eng.ny = ds._probe()
    eng.grid_hw = tuple(ds.get_trajectory(0).mask.shape)
    for k, v in extra.items():
        setattr(eng, k, v)
    return eng


def test_serve_airfoil_batch_and_client_grid_match_jax(pickles, numpy_locator):
    """The daemon's compact batch from raw airfoil grid frames (flip, trim,
    masked normalisation), and the way back to the client's units (the
    flip undone, the model grid kept since it was trimmed)."""
    folder = str(pickles / "airfoil_dataset" / "valid")
    ds = AirfoilDataset(folder, resolution=64, seq_len=4, mode="valid")
    jds = JAirfoil(folder, resolution=64, seq_len=4, mode="valid")
    eng = _bare_engine(srv.RolloutEngine, ds, device=torch.device("cpu"))
    jeng = _bare_engine(jsrv.RolloutEngine, jds)
    src = ds.get_trajectory(0)
    mask = torch.from_numpy(src.mask)
    frames = resample_to_grid(torch.from_numpy(src.node_states[100:102]),
                              torch.from_numpy(src.vert_idx), torch.from_numpy(src.weights),
                              mask).numpy()
    got = eng.build_batch(frames, src.mask, 6)
    want = jeng.build_batch(frames, src.mask, 6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6)
    info_keys = srv.RolloutEngine.info(_bare_engine(
        srv.RolloutEngine, ds, cfg=Config(), streaming=False, buckets=[6], max_batch=1,
        model=type("M", (), {"max_ctx_len": 4})()))
    assert info_keys["flip_y"] is True and info_keys["trim_patches"] is True
    px, py = ds.patch_size
    pred = np.random.default_rng(1).normal(
        size=(3, 3, ds.N_x_patch * px, ds.N_y_patch * py)).astype(np.float32)
    np.testing.assert_allclose(eng._to_client_grid(pred), jeng._to_client_grid(pred),
                               rtol=1e-6)
