"""Datasets (host-side numpy; a copy of the text-to-motion and
music-to-dance parts of motioncraft_tpu/data/datasets.py).

BaseMotionDataset (ann-file loading, pipeline, test-mode eval-index
expansion with shuffled replications, GT face/shape alignment before the
metrics), TextMotionDataset, FinedanceMotionDataset (the hardcoded
cross_genre / cross_dancer splits, the 319-d -> SMPL-X 322 remap with the
+1.3 m height offset, 163-d music features, a style caption, the 360-frame
head trim), ``beat2_pose_to_smplx322`` (the BEAT2 smplxflame layout of the
speech recordings -> SMPL-X 322) and the Repeat/Concat wrappers.  The shuffles of
``prepare_evaluation`` draw from the global numpy generator, as the JAX
package's do, so one ``np.random.seed`` gives both the same eval indexes.
The speech and mixed training datasets are not ported yet (ROADMAP queue 1:
the rest of training).
"""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional

import numpy as np

from ..registry import DATASETS
from .pipelines import Compose


@DATASETS.register_module()
class BaseMotionDataset:
    """Annotation loading + pipeline + evaluation orchestration."""

    def __init__(self, data_prefix: str, pipeline: list,
                 dataset_name: Optional[str] = None,
                 fixed_length: Optional[int] = None,
                 ann_file: Optional[str] = None,
                 motion_dir: Optional[str] = None,
                 eval_cfg: Optional[dict] = None,
                 test_mode: bool = False,
                 seed: Optional[int] = None):
        self.data_prefix = data_prefix
        self.pipeline = Compose(pipeline)
        self.dataset_name = dataset_name
        self.fixed_length = fixed_length
        if ann_file is not None:
            self.ann_file = os.path.join(data_prefix, "datasets", dataset_name, ann_file)
        if motion_dir is not None:
            self.motion_dir = os.path.join(data_prefix, "datasets", dataset_name, motion_dir)
        self.eval_cfg = copy.deepcopy(eval_cfg)
        self.test_mode = test_mode
        self.rng = np.random.default_rng(seed) if seed is not None else np.random
        self.load_annotations()
        if self.test_mode:
            self.prepare_evaluation()

    def load_anno(self, name):
        raise NotImplementedError

    def load_annotations(self):
        self.data_infos = []
        with open(self.ann_file) as f:
            for line in f:
                line = line.strip()
                if line:
                    self.data_infos.append(self.load_anno(line))

    def prepare_data(self, idx: int):
        results = copy.deepcopy(self.data_infos[idx])
        results["dataset_name"] = self.dataset_name
        results["sample_idx"] = idx
        return self.pipeline(results)

    def __len__(self):
        if self.test_mode:
            return len(self.eval_indexes)
        if self.fixed_length is not None:
            return self.fixed_length
        return len(self.data_infos)

    def __getitem__(self, idx: int):
        if self.test_mode:
            idx = self.eval_indexes[idx]
        elif self.fixed_length is not None:
            idx = idx % len(self.data_infos)
        return self.prepare_data(idx)

    def prepare_evaluation(self):
        """Build evaluators + replicated (shuffled) eval index arrays."""
        from ..eval import build_evaluator, build_evaluator_model

        self.evaluator_model = build_evaluator_model(
            self.eval_cfg.get("evaluator_model", None))
        eval_cfg = dict(self.eval_cfg)
        eval_cfg["evaluator_model"] = self.evaluator_model
        self.evaluators = []
        self.eval_indexes = []
        for _ in range(self.eval_cfg["replication_times"]):
            idxs = np.arange(len(self.data_infos))
            if self.eval_cfg.get("shuffle_indexes", False):
                np.random.shuffle(idxs)
            self.eval_indexes.append(idxs)
        for metric in self.eval_cfg["metrics"]:
            evaluator, self.eval_indexes = build_evaluator(
                metric, eval_cfg, len(self.data_infos), self.eval_indexes)
            self.evaluators.append(evaluator)
        self.eval_indexes = np.concatenate(self.eval_indexes)

    def evaluate(self, results: List[dict], work_dir=None, logger=None):
        """GT face/shape alignment then metric evaluation (the alignment is
        load-bearing for FID)."""
        if results[0]["pred_motion"].shape[-1] == 322:
            for r in results:
                pred = np.array(r["pred_motion"])  # ensure writable host copy
                pred[:, 156:309] = r["motion"][:, 156:309]
                pred[:, 312:] = r["motion"][:, 312:]
                r["pred_motion"] = pred
        metrics = {}
        for evaluator in self.evaluators:
            metrics.update(evaluator.evaluate(results))
        if logger is not None:
            logger.info(metrics)
        return metrics


@DATASETS.register_module()
class TextMotionDataset(BaseMotionDataset):
    """.npy motion + .txt captions (+ optional tokens / precomputed CLIP feats);
    random caption choice per access."""

    def __init__(self, data_prefix, pipeline, dataset_name=None, fixed_length=None,
                 ann_file=None, motion_dir=None, text_dir=None, token_dir=None,
                 clip_feat_dir=None, eval_cfg=None, test_mode=False,
                 siamese_mode=False, tcomb_mode=False, seed=None):
        join = lambda d: os.path.join(data_prefix, "datasets", dataset_name, d) if d else None
        self.text_dir = join(text_dir)
        self.token_dir = join(token_dir)
        self.clip_feat_dir = join(clip_feat_dir)
        self.siamese_mode = siamese_mode
        self.tcomb_mode = tcomb_mode
        super().__init__(data_prefix, pipeline, dataset_name, fixed_length, ann_file,
                         motion_dir, eval_cfg, test_mode, seed)

    def load_anno(self, name):
        results = {}
        if self.siamese_mode:
            data = np.load(os.path.join(self.motion_dir, name + ".npz"))
            results["motion1"], results["motion2"] = data["motion1"], data["motion2"]
        else:
            results["motion"] = np.load(os.path.join(self.motion_dir, name + ".npy"))
        with open(os.path.join(self.text_dir, name + ".txt")) as f:
            text = [line.strip() for line in f if line.strip()]
        results["text"] = text or [" "]
        if self.token_dir is not None:
            with open(os.path.join(self.token_dir, name + ".txt")) as f:
                results["token"] = [line.strip() for line in f]
        if self.clip_feat_dir is not None:
            results["clip_feat"] = np.load(os.path.join(self.clip_feat_dir, name + ".npy"))
        results["dataset_name"] = self.dataset_name
        return results

    def prepare_data(self, idx: int):
        results = copy.deepcopy(self.data_infos[idx])
        pick = int(self.rng.randint(0, len(results["text"])) if hasattr(self.rng, "randint")
                   else self.rng.integers(0, len(results["text"])))
        results["text"] = results["text"][pick]
        if "clip_feat" in results:
            results["clip_feat"] = results["clip_feat"][pick]
        if "token" in results:
            results["token"] = results["token"][pick]
        results["dataset_name"] = self.dataset_name
        results["sample_idx"] = idx
        return self.pipeline(results)


def finedance_split(datasplit: str):
    """The hardcoded FineDance splits: (train, test, ignore) track names."""
    all_list = [str(i).zfill(3) for i in range(1, 212)]
    if datasplit == "cross_genre":
        test = ["063", "132", "143", "036", "098", "198", "130", "012", "211", "193",
                "179", "065", "137", "161", "092", "120", "037", "109", "204", "144"]
        ignore = ["116", "117", "118", "119", "120", "121", "122", "123", "202", "130"]
    elif datasplit == "cross_dancer":
        test = ["001", "002", "003", "004", "005", "006", "007", "008", "009", "010",
                "011", "012", "013", "124", "126", "128", "130", "132"]
        ignore = (["115", "117", "119", "121", "122", "135", "137", "139", "141", "143",
                   "145", "147"] + ["116", "118", "120", "123", "202", "159", "130"])
    else:
        raise ValueError(f"unknown datasplit {datasplit}")
    train = [x for x in all_list if x not in test and x not in ignore]
    test = [x for x in test if x not in ignore]
    return train, test, ignore


def finedance_to_smplx322(motion_319: np.ndarray) -> np.ndarray:
    """FineDance 319-d (4 foot contacts, 3 translation, 66 body and 90 hand
    axis-angle, ...) -> SMPL-X 322, translation raised by 1.3 m in y."""
    out = np.zeros((motion_319.shape[0], 322), np.float32)
    out[:, :66] = motion_319[:, 7:73]
    out[:, 66:156] = motion_319[:, 73:163]
    out[:, 309:312] = motion_319[:, 4:7]
    out[:, 310] += 1.3
    return out


def beat2_pose_to_smplx322(pose165: np.ndarray, facial100: np.ndarray,
                           trans3: np.ndarray) -> np.ndarray:
    """BEAT2 smplxflame (165-d axis-angle: body 0:66, jaw 66:69, eyes,
    hands 75:165; 100 expression coefficients; translation) -> SMPL-X 322:
    body, hands at 66:156, jaw at 156:159, expression at 209:309,
    translation at 309:312."""
    out = np.zeros((pose165.shape[0], 322), np.float32)
    out[:, :66] = pose165[:, :66]
    out[:, 66:156] = pose165[:, 75:165]
    out[:, 156:159] = pose165[:, 66:69]
    out[:, 209:309] = facial100
    out[:, 309:312] = trans3
    return out


@DATASETS.register_module()
class FinedanceMotionDataset(BaseMotionDataset):
    """FineDance music-to-dance data: the motion remap, 163-d music
    features, a style caption from the label json and the 360-frame head
    trim.  ``ann_config`` (the BEAT2 yaml that configs/mcm/mcm_m2d_finedance.py
    inherits from its speech base) is accepted and unused; the JAX
    package's dataset refuses it."""

    def __init__(self, data_prefix, pipeline, dataset_name=None, fixed_length=None,
                 ann_file=None, motion_dir=None, text_dir=None, clip_feat_dir=None,
                 eval_cfg=None, test_mode=False, datasplit=None, music_dir=None,
                 seed=None, ann_config=None):
        self.datasplit = datasplit
        join = lambda d: os.path.join(data_prefix, "datasets", dataset_name, d) if d else None
        self.music_dir = join(music_dir)
        self.text_dir = join(text_dir)
        self.clip_feat_dir = join(clip_feat_dir)
        super().__init__(data_prefix, pipeline, dataset_name, fixed_length, ann_file,
                         motion_dir, eval_cfg, test_mode, seed)

    def load_annotations(self):
        mode = os.path.basename(self.ann_file).split(".")[0]
        train, test, _ = finedance_split(self.datasplit)
        names = train if mode == "train" else test
        self.data_infos = []
        missing = 0
        for n in names:
            if not os.path.isfile(os.path.join(self.motion_dir, n + ".npy")):
                missing += 1
                continue
            self.data_infos.append(self.load_anno(n))
        if missing:
            print(f"[FinedanceMotionDataset] skipped {missing}/{len(names)} "
                  f"missing tracks under {self.motion_dir}")

    def load_anno(self, name):
        motion = finedance_to_smplx322(np.load(os.path.join(self.motion_dir, name + ".npy")))
        music = np.load(os.path.join(self.music_dir, name + ".npy"))
        # drop the first 360 frames of both (the synchronised head trim)
        motion, music = motion[360:], music[360:]
        n = min(len(motion), len(music))
        with open(os.path.join(self.text_dir, name + ".json")) as f:
            label = json.load(f)
        text = (f"A dancer is performing a {label['style1']} dance in the "
                f"{label['style2']} style to the rhythm of the {label['name']} song.")
        return {"motion": motion[:n], "c": music[:n].astype(np.float32),
                "text": [text], "dataset_name": self.dataset_name, "name": name}

    prepare_data = TextMotionDataset.prepare_data


@DATASETS.register_module()
class RepeatDataset:
    """Oversampling wrapper."""

    def __init__(self, dataset, times: int):
        self.dataset = DATASETS.build(dataset) if isinstance(dataset, dict) else dataset
        self.times = times
        self._ori_len = len(self.dataset)

    def __getitem__(self, idx):
        return self.dataset[idx % self._ori_len]

    def __len__(self):
        return self.times * self._ori_len


@DATASETS.register_module()
class ConcatDataset:
    def __init__(self, datasets: list):
        self.datasets = [DATASETS.build(d) if isinstance(d, dict) else d for d in datasets]
        self._lens = np.cumsum([len(d) for d in self.datasets])

    def __len__(self):
        return int(self._lens[-1])

    def __getitem__(self, idx):
        ds = int(np.searchsorted(self._lens, idx, side="right"))
        prev = 0 if ds == 0 else int(self._lens[ds - 1])
        return self.datasets[ds][idx - prev]
