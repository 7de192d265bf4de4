"""BaseDataModule: bundles train/val/test datasets + loaders.

Mirrors the reference LightningDataModule (`src/data/base_datamodule.py:15`)
including the quirk of picking the point-cloud collate when the dataset's
repr contains "pcd" (`base_datamodule.py:111`). The point-cloud collate here
is the padded/bucketed one.
"""

from __future__ import annotations

import functools
from typing import Any

from pointcloudmatters_tpu.data.collate import default_collate, padded_pcd_collate_fn
from pointcloudmatters_tpu.data.loader import DataLoader


class BaseDataModule:
    def __init__(
        self,
        train: Any = None,
        val: Any = None,
        test: Any = None,
        batch_size_train: int = 16,
        batch_size_val: int = 1,
        batch_size_test: int = 1,
        num_workers: int = 0,
        pin_memory: bool = True,
        pad_multiple: int = 512,
        seed: int = 0,
    ):
        self.data_train = train
        self.data_val = val
        self.data_test = test
        self.batch_size_train = batch_size_train
        self.batch_size_val = batch_size_val
        self.batch_size_test = batch_size_test
        self.num_workers = num_workers
        self.pin_memory = pin_memory  # accepted for config parity; no-op here
        self.pad_multiple = pad_multiple
        self.seed = seed

    def setup(self, stage: str | None = None) -> None:
        pass

    def _collate_for(self, dataset):
        if hasattr(dataset, "_collate_fn"):
            return dataset._collate_fn
        if "pcd" not in repr(dataset).lower() and "pcd" not in type(dataset).__name__.lower():
            return default_collate
        return functools.partial(padded_pcd_collate_fn, pad_multiple=self.pad_multiple)

    def _loader(self, dataset, batch_size, shuffle):
        return DataLoader(
            dataset,
            batch_size=batch_size,
            shuffle=shuffle,
            num_workers=self.num_workers,
            collate_fn=self._collate_for(dataset),
            drop_last=shuffle,  # stable shapes for the jitted train step
            seed=self.seed,
        )

    def train_dataloader(self) -> DataLoader:
        return self._loader(self.data_train, self.batch_size_train, shuffle=True)

    def val_dataloader(self) -> DataLoader | None:
        if self.data_val is None:
            return None
        return self._loader(self.data_val, self.batch_size_val, shuffle=False)

    def test_dataloader(self) -> DataLoader | None:
        if self.data_test is None:
            return None
        return self._loader(self.data_test, self.batch_size_test, shuffle=False)
