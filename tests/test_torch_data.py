"""The port's data layer against the JAX package's (CPU, no model).

Frame readers on files written by the JAX package's writers, the two
augmentors under the same ``np.random.Generator`` seeds, every dataset
class on mini-trees (same files in the same order, the same samples with
``epoch``-seeded augmentation), and ``build_training_mixture``.  Everything
here is host-side numpy in both packages, so every comparison is bit for
bit.  The JAX package reads PFM and PNG through its ``native`` decoders
where ``libstereo_native.so`` is built; the port has Python readers only.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from golden_data import make_all_benchmarks, make_middlebury
from raft_stereo_tpu.config import TrainConfig as JaxTrainConfig
from raft_stereo_tpu.data import augment as jaug
from raft_stereo_tpu.data import datasets as jds
from raft_stereo_tpu.data import frame_utils as jfu
from raft_stereo_tpu_torch.config import TrainConfig
from raft_stereo_tpu_torch.data import augment as paug
from raft_stereo_tpu_torch.data import datasets as pds
from raft_stereo_tpu_torch.data import frame_utils as pfu


def _equal(got, want):
    """Bit-equal arrays, or tuples of arrays, of one dtype and shape."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _write_pfm3(path, array):
    """A 3-channel 'PF' map, big-endian (positive scale), rows bottom-up."""
    h, w, _ = array.shape
    with open(path, "wb") as f:
        f.write(b"PF\n" + f"{w} {h}\n".encode() + b"1.0\n")
        f.write(np.flipud(array).astype(">f4").tobytes())


# --------------------------------------------------------------- readers
@pytest.fixture(scope="module")
def gt_files(tmp_path_factory):
    """One file of every GT format, written by the JAX package's writers
    where it has one."""
    root = tmp_path_factory.mktemp("gt")
    rng = np.random.default_rng(11)
    disp = rng.uniform(0.5, 90, (23, 37)).astype(np.float32)
    disp[3, 4] = np.inf
    files = {}
    files["pfm1"] = str(root / "disp.pfm")
    jfu.write_pfm(files["pfm1"], disp)
    files["pfm3"] = str(root / "color.pfm")
    _write_pfm3(files["pfm3"], rng.normal(size=(23, 37, 3)).astype(np.float32))
    files["flo"] = str(root / "flow.flo")
    jfu.write_flo(files["flo"], rng.normal(size=(23, 37, 2)).astype(
        np.float32))
    files["kitti"] = str(root / "000000_10.png")
    kitti = disp.copy()
    kitti[rng.random(kitti.shape) < 0.3] = 0
    kitti[~np.isfinite(kitti)] = 0
    jfu.write_disp_kitti(files["kitti"], kitti)
    # Sintel: disparities/<scene>/frame.png with occlusions/<scene>/frame.png
    for sub in ("disparities", "occlusions"):
        (root / "sintel" / sub / "alley").mkdir(parents=True)
    files["sintel"] = str(root / "sintel" / "disparities" / "alley" /
                          "frame_0001.png")
    Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)).save(
        files["sintel"])
    Image.fromarray(np.where(rng.random((23, 37)) < 0.2, 255, 0).astype(
        np.uint8)).save(files["sintel"].replace("disparities", "occlusions"))
    # FallingThings: 16-bit depth PNG and the scene's camera JSON
    (root / "ft").mkdir()
    files["ft"] = str(root / "ft" / "000000.left.depth.png")
    depth = rng.integers(0, 60000, (23, 37)).astype(np.uint16)
    depth[0, :5] = 0
    Image.fromarray(depth).save(files["ft"])
    with open(root / "ft" / "_camera_settings.json", "w") as f:
        json.dump({"camera_settings": [
            {"intrinsic_settings": {"fx": 768.1605834960938}}]}, f)
    # TartanAir: .npy depth
    files["tartan"] = str(root / "000000_left_depth.npy")
    np.save(files["tartan"], rng.uniform(0.5, 50, (23, 37)).astype(
        np.float32))
    # Middlebury: disp0GT.pfm and mask0nocc.png
    (root / "mb").mkdir()
    files["mb"] = str(root / "mb" / "disp0GT.pfm")
    jfu.write_pfm(files["mb"], disp)
    Image.fromarray(np.where(rng.random((23, 37)) < 0.2, 128, 255).astype(
        np.uint8)).save(str(root / "mb" / "mask0nocc.png"))
    files["image"] = str(root / "im.png")
    Image.fromarray(rng.integers(0, 256, (23, 37, 3), dtype=np.uint8)).save(
        files["image"])
    files["gray16"] = str(root / "gray16.png")
    Image.fromarray(rng.integers(0, 65535, (23, 37)).astype(np.uint16)).save(
        files["gray16"])
    return files


READERS = [
    ("pfm1", "read_pfm"), ("pfm3", "read_pfm"), ("flo", "read_flo"),
    ("kitti", "read_disp_kitti"), ("sintel", "read_disp_sintel"),
    ("ft", "read_disp_falling_things"), ("tartan", "read_disp_tartanair"),
    ("mb", "read_disp_middlebury"), ("image", "read_image"),
    ("gray16", "read_image"), ("pfm1", "read_gen"), ("pfm3", "read_gen"),
    ("flo", "read_gen"), ("tartan", "read_gen"), ("image", "read_gen"),
]


@pytest.mark.parametrize("which,reader", READERS,
                         ids=[f"{r}-{w}" for w, r in READERS])
def test_readers_bit_equal(gt_files, which, reader):
    _equal(getattr(pfu, reader)(gt_files[which]),
           getattr(jfu, reader)(gt_files[which]))


def test_writers_bit_equal(tmp_path):
    rng = np.random.default_rng(2)
    disp = rng.uniform(0, 200, (17, 29)).astype(np.float32)
    flow = rng.normal(size=(17, 29, 2)).astype(np.float32)
    for name, arg in (("write_pfm", disp), ("write_flo", flow),
                      ("write_disp_kitti", disp)):
        ext = {"write_pfm": ".pfm", "write_flo": ".flo"}.get(name, ".png")
        getattr(pfu, name)(str(tmp_path / f"p{ext}"), arg)
        getattr(jfu, name)(str(tmp_path / f"j{ext}"), arg)
        if ext == ".png":  # PNG bytes may carry encoder metadata
            _equal(np.asarray(Image.open(tmp_path / f"p{ext}")),
                   np.asarray(Image.open(tmp_path / f"j{ext}")))
        else:
            assert (tmp_path / f"p{ext}").read_bytes() == \
                (tmp_path / f"j{ext}").read_bytes()


# ----------------------------------------------------------- augmentors
def _aug_inputs(seed, hw=(72, 110)):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    img2 = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    flow = np.stack([-rng.uniform(0, 30, hw), np.zeros(hw)], -1).astype(
        np.float32)
    valid = (rng.random(hw) < 0.6).astype(np.float32)
    return img1, img2, flow, valid


AUG_CASES = [(None, False, (1, 1, 1, 1)), ("h", True, (1, 1, 1, 1)),
             ("v", False, (0.8, 1.2, 0.9, 1.1)), ("hf", True, (1, 1, 1, 1))]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("do_flip,yjitter,gamma", AUG_CASES)
def test_dense_augmentor_bit_equal(seed, do_flip, yjitter, gamma):
    img1, img2, flow, _ = _aug_inputs(seed)
    kw = dict(crop_size=(40, 64), do_flip=do_flip, yjitter=yjitter,
              gamma=gamma)
    got = paug.DenseAugmentor(**kw)(img1, img2, flow,
                                    np.random.default_rng(seed + 100))
    want = jaug.DenseAugmentor(**kw)(img1, img2, flow,
                                     np.random.default_rng(seed + 100))
    _equal(tuple(got), tuple(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("do_flip,yjitter,gamma", AUG_CASES)
def test_sparse_augmentor_bit_equal(seed, do_flip, yjitter, gamma):
    img1, img2, flow, valid = _aug_inputs(seed)
    kw = dict(crop_size=(40, 64), do_flip=do_flip, yjitter=yjitter,
              gamma=gamma, saturation_range=(0.5, 1.5))
    got = paug.SparseAugmentor(**kw)(img1, img2, flow, valid,
                                     np.random.default_rng(seed + 200))
    want = jaug.SparseAugmentor(**kw)(img1, img2, flow, valid,
                                      np.random.default_rng(seed + 200))
    _equal(tuple(got), tuple(want))


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_and_eraser_bit_equal(seed):
    img1, img2, _, _ = _aug_inputs(seed)
    jitter = dict(brightness=0.4, contrast=0.4, saturation=(0.6, 1.4),
                  hue=0.5 / 3.14, gamma=(0.7, 1.3, 0.9, 1.1))
    _equal(paug.ColorJitter(**jitter)(img1, np.random.default_rng(seed)),
           jaug.ColorJitter(**jitter)(img1, np.random.default_rng(seed)))
    _equal(paug._eraser(img2, np.random.default_rng(seed), prob=1.0),
           jaug._eraser(img2, np.random.default_rng(seed), prob=1.0))


# --------------------------------------------------------------- datasets
def _png(path, rng, hw, dtype=np.uint8, channels=3):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    shape = hw + ((channels,) if channels > 1 else ())
    hi = 256 if dtype == np.uint8 else 60000
    Image.fromarray(rng.integers(1, hi, shape).astype(dtype)).save(path)


def _make_training_trees(root, rng, hw=(60, 90)):
    """Mini-trees of the training-only datasets in the reference's
    layouts: SceneFlow TRAIN (FlyingThings3D, Monkaa, Driving; clean and
    final passes), SintelStereo, FallingThings and TartanAir."""
    def disp_pfm(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        jfu.write_pfm(path, rng.uniform(1, 20, hw).astype(np.float32))

    for dstype in ("frames_cleanpass", "frames_finalpass"):
        for left in (
                f"FlyingThings3D/{dstype}/TRAIN/A/0000/left/0006.png",
                f"FlyingThings3D/{dstype}/TRAIN/B/0001/left/0007.png",
                f"Monkaa/{dstype}/a_rain/left/0000.png",
                f"Driving/{dstype}/15mm/scene_forwards/fast/left/0001.png"):
            _png(os.path.join(root, left), rng, hw)
            _png(os.path.join(root, left.replace("left", "right")), rng, hw)
            disp_pfm(os.path.join(root, left.replace(dstype, "disparity")
                                  .replace(".png", ".pfm")))
    sintel = os.path.join(root, "SintelStereo", "training")
    for scene in ("alley_1", "bamboo_2"):
        for f in ("frame_0001.png", "frame_0002.png"):
            for side in ("clean_left", "clean_right", "final_left",
                         "final_right"):
                _png(os.path.join(sintel, side, scene, f), rng, hw)
            _png(os.path.join(sintel, "disparities", scene, f), rng, hw)
            _png(os.path.join(sintel, "occlusions", scene, f), rng, hw,
                 channels=1)
    ft = os.path.join(root, "FallingThings")
    names = []
    for scene in ("kitchen_0", "mixed_3"):
        for i in range(2):
            e = f"fat/single/{scene}/{i:06d}.left.jpg"
            names.append(e)
            for side in ("left", "right"):
                path = os.path.join(ft, e.replace("left", side))
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(rng.integers(0, 256, hw + (3,)).astype(
                    np.uint8)).save(path)
            _png(os.path.join(ft, e.replace("left.jpg", "left.depth.png")),
                 rng, hw, np.uint16, 1)
        with open(os.path.join(ft, "fat/single", scene,
                               "_camera_settings.json"), "w") as f:
            json.dump({"camera_settings": [
                {"intrinsic_settings": {"fx": 768.16}}]}, f)
    with open(os.path.join(ft, "filenames.txt"), "w") as f:
        f.write("\n".join(names[::-1]) + "\n")
    tnames = []
    for env in ("abandonedfactory/Easy/P000", "seasonsforest_winter/Easy/P001",
                "Office/Hard/P002"):
        for i in range(2):
            e = f"{env}/image_left/{i:06d}_left.png"
            tnames.append(e)
            _png(os.path.join(root, e), rng, hw)
            _png(os.path.join(root, e.replace("_left", "_right")), rng, hw)
            depth = os.path.join(root, e.replace("image_left", "depth_left")
                                 .replace("left.png", "left_depth.npy"))
            os.makedirs(os.path.dirname(depth), exist_ok=True)
            np.save(depth, rng.uniform(1, 40, hw).astype(np.float32))
    with open(os.path.join(root, "tartanair_filenames.txt"), "w") as f:
        f.write("\n".join(tnames) + "\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(datasets root, Middlebury-F root): the four benchmarks' mini-trees
    of tests/golden_data.py, the training-only datasets, and a trainingF
    Middlebury tree."""
    base = str(tmp_path_factory.mktemp("trees"))
    make_all_benchmarks(base)
    root = os.path.join(base, "datasets")
    _make_training_trees(root, np.random.default_rng(5))
    mb_f = os.path.join(base, "mbF")
    make_middlebury(mb_f, np.random.default_rng(6), split="F")
    return root, mb_f


AUG = {"crop_size": (40, 64), "min_scale": -0.2, "max_scale": 0.4,
       "do_flip": "h", "yjitter": True}


def _dataset_pairs(root, mb_f, aug):
    """(name, port dataset, JAX dataset) for every class."""
    sparse_aug = None if aug is None else {k: v for k, v in aug.items()}
    out = []
    for name, kw in (
            ("things_test", dict(root=root, dstype="frames_finalpass",
                                 things_test=True)),
            ("sceneflow_clean", dict(root=root, dstype="frames_cleanpass")),
            ("eth3d", dict(root=os.path.join(root, "ETH3D"))),
            ("kitti", dict(root=os.path.join(root, "KITTI"))),
            ("middlebury_H", dict(root=os.path.join(root, "Middlebury"),
                                  split="H")),
            ("middlebury_F", dict(root=mb_f, split="F")),
            ("sintel", dict(root=os.path.join(root, "SintelStereo"))),
            ("falling_things", dict(root=os.path.join(root,
                                                      "FallingThings"))),
            ("tartan_air", dict(root=root, keywords=("easy",))),
            ("tartan_air_all", dict(root=root))):
        cls = {"things_test": "SceneFlow", "sceneflow_clean": "SceneFlow",
               "eth3d": "ETH3D", "kitti": "KITTI",
               "middlebury_H": "Middlebury", "middlebury_F": "Middlebury",
               "sintel": "SintelStereo", "falling_things": "FallingThings",
               "tartan_air": "TartanAir", "tartan_air_all": "TartanAir"}[name]
        out.append((name, getattr(pds, cls)(sparse_aug, seed=3, **kw),
                    getattr(jds, cls)(sparse_aug, seed=3, **kw)))
    return out


NAMES = ["things_test", "sceneflow_clean", "eth3d", "kitti", "middlebury_H",
         "middlebury_F", "sintel", "falling_things", "tartan_air",
         "tartan_air_all"]


@pytest.mark.parametrize("augmented", [False, True],
                         ids=["plain", "augmented"])
@pytest.mark.parametrize("name", NAMES)
def test_datasets_same_files_and_samples(trees, name, augmented):
    root, mb_f = trees
    pairs = {n: (p, j) for n, p, j in _dataset_pairs(
        root, mb_f, AUG if augmented else None)}
    port, jax_ds = pairs[name]
    assert len(port) == len(jax_ds) > 0
    assert [port.sample_paths(i) for i in range(len(port))] == \
        [jax_ds.sample_paths(i) for i in range(len(jax_ds))]
    for i in range(len(port)):
        for epoch in ((0, 3) if augmented else (0,)):
            got = port.__getitem__(i, epoch)
            want = jax_ds.__getitem__(i, epoch)
            assert sorted(got) == sorted(want)
            for key in want:
                _equal(got[key], want[key])


def test_training_mixture_same_lengths_and_order(trees):
    root, _ = trees
    kw = dict(image_size=(40, 64), do_flip="h", seed=9,
              saturation_range=(0.5, 1.5), img_gamma=(0.9, 1.1, 1.0, 1.0),
              train_datasets=("sceneflow", "kitti", "sintel_stereo",
                              "falling_things", "tartan_air_easy",
                              "middlebury_H"))
    got = pds.build_training_mixture(TrainConfig(**kw), data_root=root)
    want = jds.build_training_mixture(JaxTrainConfig(**kw), data_root=root)
    assert len(got) == len(want) > 0
    assert [got.sample_paths(i) for i in range(len(got))] == \
        [want.sample_paths(i) for i in range(len(want))]
    for i in (0, len(got) // 2, len(got) - 1):
        g, w = got.__getitem__(i, 2), want.__getitem__(i, 2)
        for key in w:
            _equal(g[key], w[key])
    with pytest.raises(ValueError, match="unknown training dataset"):
        pds.build_training_mixture(TrainConfig(train_datasets=("nope",)),
                                   data_root=root)
