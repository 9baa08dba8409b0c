"""Datasets (host-side numpy; a copy of the text-to-motion part of
motioncraft_tpu/data/datasets.py).

BaseMotionDataset (ann-file loading, pipeline, test-mode eval-index
expansion with shuffled replications, GT face/shape alignment before the
metrics), TextMotionDataset and the Repeat/Concat wrappers.  The shuffles of
``prepare_evaluation`` draw from the global numpy generator, as the JAX
package's do, so one ``np.random.seed`` gives both the same eval indexes.
The FineDance, speech and mixed datasets are not ported yet (they come with
speech-to-gesture and music-to-dance).
"""

from __future__ import annotations

import copy
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
