"""Stereo dataset registry (host side, numpy): the JAX package's
``data/datasets.py``, listing the same files in the same order.

Covers the reference's seven dataset families and its training-mixture
recipe (reference: core/stereo_datasets.py).  Differences by design:

* Samples are plain dicts of numpy arrays in HWC layout; the runner and
  the loader stack them into device batches.
* Datasets are index-lists built eagerly at construction; replication for
  mixture weighting is ``dataset * k`` like the reference (:111-117).
* Augmentation RNG is derived per ``(seed, index)`` — reproducible under
  any worker scheduling (reference reseeds per torch worker, :55-61).
* The reference's ``fetch_dataloader`` crashes when training on KITTI
  (passes an unsupported ``split=`` kwarg — core/stereo_datasets.py:298);
  here KITTI is registered properly.
"""

from __future__ import annotations

import copy
import glob
import logging
import os
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_stereo_tpu_torch.data import frame_utils
from raft_stereo_tpu_torch.data.augment import DenseAugmentor, SparseAugmentor

log = logging.getLogger(__name__)

MAX_FLOW_MAGNITUDE = 512.0  # dense-GT validity cutoff (stereo_datasets.py:97)


class StereoDataset:
    """Base dataset: image pair + disparity GT → training sample dict.

    ``__getitem__(i, epoch)`` returns
    ``{"image1", "image2"}: (H,W,3) uint8 0..255 (normalized on the
      device by the model; uint8 quarters the host->device transfer),
      "flow": (H,W) float32 x-flow (= -disparity),
      "valid": (H,W) float32 in {0,1}`` — cropped to ``crop_size`` when an
    augmentor is configured.
    """

    def __init__(self, aug_params: Optional[dict] = None, sparse: bool = False,
                 reader: Optional[Callable] = None, seed: int = 1234):
        self.sparse = sparse
        self.reader = reader or frame_utils.read_gen
        self.seed = seed
        self.augmentor = None
        self.img_pad = None
        if aug_params is not None:
            aug_params = dict(aug_params)
            self.img_pad = aug_params.pop("img_pad", None)
            if "crop_size" in aug_params:
                cls = SparseAugmentor if sparse else DenseAugmentor
                self.augmentor = cls(**aug_params)
        self.image_list: List[Tuple[str, str]] = []
        self.disparity_list: List[str] = []

    # -------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return len(self.image_list)

    def __mul__(self, k: int) -> "StereoDataset":
        """Replicate the index for mixture weighting
        (reference: core/stereo_datasets.py:111-117)."""
        out = copy.copy(self)
        out.image_list = self.image_list * k
        out.disparity_list = self.disparity_list * k
        return out

    def __add__(self, other: "StereoDataset") -> "StereoDataset":
        out = ConcatStereoDataset([self, other])
        return out

    def sample_paths(self, index: int):
        left, right = self.image_list[index]
        return left, right, self.disparity_list[index]

    def __getitem__(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        index = index % len(self.image_list)
        left_path, right_path = self.image_list[index]
        img1 = frame_utils.read_image(left_path)
        img2 = frame_utils.read_image(right_path)

        disp = self.reader(self.disparity_list[index])
        if isinstance(disp, tuple):
            disp, valid = disp
        else:
            valid = disp < MAX_FLOW_MAGNITUDE
        disp = np.asarray(disp, np.float32)
        # disparity → x-flow; left image's match lies to the LEFT in the
        # right image (reference: core/stereo_datasets.py:77)
        flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)

        if self.augmentor is not None:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch, index]))
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(
                    img1, img2, flow, valid.astype(np.float32), rng)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow, rng)

        if self.sparse:
            valid = np.asarray(valid, np.float32)
        else:
            valid = ((np.abs(flow[..., 0]) < MAX_FLOW_MAGNITUDE)
                     & (np.abs(flow[..., 1]) < MAX_FLOW_MAGNITUDE)
                     ).astype(np.float32)

        if self.img_pad is not None:
            pad_h, pad_w = self.img_pad
            pad = ((pad_h, pad_h), (pad_w, pad_w), (0, 0))
            img1 = np.pad(img1, pad)
            img2 = np.pad(img2, pad)

        # Images stay uint8: the decode/augment chain is uint8 end to end
        # and the model normalizes on the device, so a float cast here
        # would only 4x the host->device transfer.
        return {
            "image1": np.ascontiguousarray(img1),
            "image2": np.ascontiguousarray(img2),
            "flow": np.ascontiguousarray(flow[..., 0], np.float32),
            "valid": valid,
        }


class ConcatStereoDataset(StereoDataset):
    def __init__(self, parts: Sequence[StereoDataset]):
        super().__init__(aug_params=None)
        self.parts = []
        for p in parts:  # flatten nested concats
            self.parts.extend(p.parts if isinstance(p, ConcatStereoDataset)
                              else [p])
        self._lengths = [len(p) for p in self.parts]
        self._offsets = np.cumsum([0] + self._lengths)

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, index: int):
        index = index % len(self)
        part = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.parts[part], index - int(self._offsets[part])

    def sample_paths(self, index: int):
        part, local = self._locate(index)
        return part.sample_paths(local)

    def __getitem__(self, index: int, epoch: int = 0):
        part, local = self._locate(index)
        return part.__getitem__(local, epoch)


# ------------------------------------------------------------------ datasets
class SceneFlow(StereoDataset):
    """FlyingThings3D + Monkaa + Driving (reference:
    core/stereo_datasets.py:123-184).  TEST split keeps the fixed-seed-1000
    400-image validation subset."""

    VAL_SUBSET_SEED = 1000
    VAL_SUBSET_SIZE = 400

    def __init__(self, aug_params=None, root="datasets",
                 dstype="frames_cleanpass", things_test=False, seed=1234):
        super().__init__(aug_params, seed=seed)
        self.root = root
        self.dstype = dstype
        if things_test:
            self._add_things("TEST")
        else:
            self._add_things("TRAIN")
            self._add_monkaa()
            self._add_driving()

    def _pairs(self, left_images):
        right = [p.replace("left", "right") for p in left_images]
        disp = [p.replace(self.dstype, "disparity").replace(".png", ".pfm")
                for p in left_images]
        return right, disp

    def _add_things(self, split):
        before = len(self)
        root = os.path.join(self.root, "FlyingThings3D")
        left = sorted(glob.glob(
            os.path.join(root, self.dstype, split, "*/*/left/*.png")))
        right, disp = self._pairs(left)
        # fixed validation subset, independent of global RNG state
        val_idxs = set()
        if split == "TEST":
            rng = np.random.RandomState(self.VAL_SUBSET_SEED)
            val_idxs = set(rng.permutation(len(left))[:self.VAL_SUBSET_SIZE])
        for i, (l, r, d) in enumerate(zip(left, right, disp)):
            if split == "TRAIN" or i in val_idxs:
                self.image_list.append((l, r))
                self.disparity_list.append(d)
        log.info("Added %d from FlyingThings %s", len(self) - before,
                 self.dstype)

    def _add_monkaa(self):
        before = len(self)
        root = os.path.join(self.root, "Monkaa")
        left = sorted(glob.glob(os.path.join(root, self.dstype,
                                             "*/left/*.png")))
        right, disp = self._pairs(left)
        self.image_list += list(zip(left, right))
        self.disparity_list += disp
        log.info("Added %d from Monkaa %s", len(self) - before, self.dstype)

    def _add_driving(self):
        before = len(self)
        root = os.path.join(self.root, "Driving")
        left = sorted(glob.glob(os.path.join(root, self.dstype,
                                             "*/*/*/left/*.png")))
        right, disp = self._pairs(left)
        self.image_list += list(zip(left, right))
        self.disparity_list += disp
        log.info("Added %d from Driving %s", len(self) - before, self.dstype)


class ETH3D(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/ETH3D",
                 split="training", seed=1234):
        super().__init__(aug_params, sparse=True, seed=seed)
        left = sorted(glob.glob(os.path.join(root, f"two_view_{split}/*/im0.png")))
        right = sorted(glob.glob(os.path.join(root, f"two_view_{split}/*/im1.png")))
        if split == "training":
            disp = sorted(glob.glob(
                os.path.join(root, "two_view_training_gt/*/disp0GT.pfm")))
        else:  # test split has no GT; reference substitutes a fixed file
            disp = [os.path.join(root, "two_view_training_gt/playground_1l/"
                                 "disp0GT.pfm")] * len(left)
        # default read_gen reader: PFM, valid = disp < 512 (inf GT → invalid)
        self.image_list = list(zip(left, right))
        self.disparity_list = disp


class SintelStereo(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/SintelStereo",
                 seed=1234):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_sintel, seed=seed)
        left = sorted(glob.glob(
            os.path.join(root, "training/*_left/*/frame_*.png")))
        right = sorted(glob.glob(
            os.path.join(root, "training/*_right/*/frame_*.png")))
        # one disparity tree serves both the clean and final passes
        disp = sorted(glob.glob(
            os.path.join(root, "training/disparities/*/frame_*.png"))) * 2
        for l, r, d in zip(left, right, disp):
            if l.split(os.sep)[-2:] != d.split(os.sep)[-2:]:
                raise ValueError(f"Sintel pair {l} has GT {d}")
            self.image_list.append((l, r))
            self.disparity_list.append(d)


class FallingThings(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/FallingThings",
                 seed=1234):
        super().__init__(aug_params,
                         reader=frame_utils.read_disp_falling_things,
                         seed=seed)
        with open(os.path.join(root, "filenames.txt")) as f:
            names = sorted(f.read().splitlines())
        for e in names:
            self.image_list.append((
                os.path.join(root, e),
                os.path.join(root, e.replace("left.jpg", "right.jpg"))))
            self.disparity_list.append(
                os.path.join(root, e.replace("left.jpg", "left.depth.png")))


class TartanAir(StereoDataset):
    def __init__(self, aug_params=None, root="datasets", keywords=(),
                 seed=1234):
        super().__init__(aug_params, reader=frame_utils.read_disp_tartanair,
                         seed=seed)
        with open(os.path.join(root, "tartanair_filenames.txt")) as f:
            names = [s for s in f.read().splitlines()
                     if "seasonsforest_winter/Easy" not in s]
        for kw in keywords:
            names = [s for s in names if kw in s.lower()]
        for e in sorted(names):
            self.image_list.append((
                os.path.join(root, e),
                os.path.join(root, e.replace("_left", "_right"))))
            self.disparity_list.append(os.path.join(
                root, e.replace("image_left", "depth_left")
                       .replace("left.png", "left_depth.npy")))


class KITTI(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/KITTI",
                 image_set="training", seed=1234):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_kitti, seed=seed)
        left = sorted(glob.glob(os.path.join(root, image_set,
                                             "image_2/*_10.png")))
        right = sorted(glob.glob(os.path.join(root, image_set,
                                              "image_3/*_10.png")))
        if image_set == "training":
            disp = sorted(glob.glob(os.path.join(root, "training",
                                                 "disp_occ_0/*_10.png")))
        else:  # no GT for the test set; fixed placeholder like the reference
            disp = [os.path.join(root, "training/disp_occ_0/000085_10.png")
                    ] * len(left)
        self.image_list = list(zip(left, right))
        self.disparity_list = disp


class Middlebury(StereoDataset):
    def __init__(self, aug_params=None, root="datasets/Middlebury",
                 split="F", seed=1234):
        super().__init__(aug_params, sparse=True,
                         reader=frame_utils.read_disp_middlebury, seed=seed)
        if split not in ("F", "H", "Q"):
            raise ValueError(f"Middlebury split {split!r} not in F, H, Q")
        official = Path(os.path.join(
            root, "MiddEval3/official_train.txt")).read_text().splitlines()
        scenes = [os.path.basename(p) for p in
                  glob.glob(os.path.join(root, "MiddEval3/trainingF/*"))]
        scenes = sorted(s for s in scenes if s in official)
        base = os.path.join(root, "MiddEval3", f"training{split}")
        for name in scenes:
            self.image_list.append((os.path.join(base, name, "im0.png"),
                                    os.path.join(base, name, "im1.png")))
            self.disparity_list.append(
                os.path.join(base, name, "disp0GT.pfm"))
        if not self.image_list:
            raise ValueError(f"no Middlebury scenes under {root!r} "
                             f"(split {split})")


DATASETS = {
    "sceneflow": SceneFlow,
    "eth3d": ETH3D,
    "sintel_stereo": SintelStereo,
    "falling_things": FallingThings,
    "tartan_air": TartanAir,
    "kitti": KITTI,
    "middlebury": Middlebury,
}


# ------------------------------------------------------------------ mixtures
def build_training_mixture(train_cfg, data_root: str = "datasets"
                           ) -> StereoDataset:
    """Assemble the training mixture from ``TrainConfig``
    (reference: core/stereo_datasets.py:277-309 ``fetch_dataloader``)."""
    aug_params = {
        "crop_size": tuple(train_cfg.image_size),
        "min_scale": train_cfg.spatial_scale[0],
        "max_scale": train_cfg.spatial_scale[1],
        "do_flip": train_cfg.do_flip,
        "yjitter": not train_cfg.noyjitter,
        # device_photometric moves the jitter into the training step
        # (data/device_jitter.py); the host augmentor then skips it
        "photometric": not train_cfg.device_photometric,
    }
    if train_cfg.saturation_range is not None:
        aug_params["saturation_range"] = tuple(train_cfg.saturation_range)
    if train_cfg.img_gamma is not None:
        aug_params["gamma"] = tuple(train_cfg.img_gamma)

    seed = train_cfg.seed
    mixture = None
    for name in train_cfg.train_datasets:
        if re.fullmatch(r"middlebury_.*", name):
            ds = Middlebury(aug_params, root=os.path.join(data_root,
                                                          "Middlebury"),
                            split=name.removeprefix("middlebury_"), seed=seed)
        elif name == "sceneflow":
            # 4× clean + 4× final (reference: core/stereo_datasets.py:292-296)
            clean = SceneFlow(aug_params, root=data_root,
                              dstype="frames_cleanpass", seed=seed)
            final = SceneFlow(aug_params, root=data_root,
                              dstype="frames_finalpass", seed=seed)
            ds = (clean * 4) + (final * 4)
        elif "kitti" in name:
            ds = KITTI(aug_params, root=os.path.join(data_root, "KITTI"),
                       seed=seed)
        elif name == "sintel_stereo":
            ds = SintelStereo(aug_params,
                              root=os.path.join(data_root, "SintelStereo"),
                              seed=seed) * 140
        elif name == "falling_things":
            ds = FallingThings(aug_params,
                               root=os.path.join(data_root, "FallingThings"),
                               seed=seed) * 5
        elif name.startswith("tartan_air"):
            ds = TartanAir(aug_params, root=data_root,
                           keywords=name.split("_")[2:], seed=seed)
        else:
            raise ValueError(f"unknown training dataset {name!r}")
        log.info("Adding %d samples from %s", len(ds), name)
        mixture = ds if mixture is None else mixture + ds
    if mixture is None or len(mixture) == 0:
        raise ValueError(
            f"empty training mixture from {train_cfg.train_datasets} "
            f"under {data_root!r}")
    return mixture
