"""Predictor hub — trains, caches, and persists `PredictorBank`s.

One bank per (device setting × predictor family).  Training reads arch
records out of a `ProfileStore` (the persisted profiling pass) and runs
the paper's §4.2 flow — per-op-type fits + T_overhead estimation —
via `repro.core.dataset.fit_predictor_bank`.  Banks round-trip to JSON
(every predictor family serializes bit-exactly), so a trained hub can
be shipped to a serving process that never profiles.

Port notes: the hub's ``device`` (the card unless ``device="cpu"``) is
where the device-bound families — lasso and the MLP — train, and where
banks read from disk rebuild them; tree banks do not use it.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

from repro_torch.core.composition import PredictorBank
from repro_torch.core.profiler import DeviceSetting
from repro_torch.pipeline.store import ProfileStore, setting_key
from repro_torch.utils.device import DeviceLike
from repro_torch.utils.logging import get_logger

log = get_logger("repro.pipeline.hub")

FAMILIES = ("lasso", "rf", "gbdt", "mlp")


def _bank_filename(key: str, family: str) -> str:
    return f"bank__{key.replace('/', '__')}__{family}.json"


class PredictorHub:
    """Registry of trained per-op-type predictor banks.

    ``root`` (optional) is a directory where banks are saved as one JSON
    file each; `load` restores every bank found there.  ``device`` is
    where lasso and MLP banks train and are restored.
    """

    def __init__(self, root: Optional[str] = None, device: DeviceLike = "cuda"):
        self.root = root
        self.device = device
        self.banks: Dict[Tuple[str, str], PredictorBank] = {}
        # Bumped on every (re)train so caches keyed on hub output —
        # LatencyService's report LRU — know to invalidate.
        self.version = 0
        # Rollover bookkeeping: every install (train/register/swap)
        # stamps its bank with the next hub-wide epoch, so a serving
        # report can attribute which generation of a bank answered it
        # (banks only read from disk keep epoch 0 — they predate the
        # hub's lifetime).  Guarded by _lock together with version so
        # (bank, epoch) snapshots are consistent under rollover.
        self.epoch = 0
        self.bank_epochs: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()
        # Training-dataset assembly cache: training several families on
        # the same (setting, split) reuses one LatencyDataset (and its
        # one-pass per-type tables) instead of re-reading the store.
        # Keyed with len(store) so new measurements invalidate.
        self._ds_cache: Dict[Tuple, Any] = {}

    # -- training ------------------------------------------------------------
    def train(
        self,
        store: ProfileStore,
        setting: DeviceSetting,
        family: str = "gbdt",
        *,
        hparams: Optional[Dict[str, Any]] = None,
        min_samples: int = 5,
        seed: int = 0,
        overhead_model: str = "affine",
        fingerprints: Optional[Sequence[str]] = None,
        save: bool = True,
    ) -> PredictorBank:
        """Fit one bank from the store's arch records for ``setting``.

        ``fingerprints`` restricts training to those graphs (train/test
        splits); default is everything profiled under the setting.
        """
        if family not in FAMILIES:
            raise ValueError(f"unknown predictor family {family!r}; "
                             f"known: {FAMILIES}")
        from repro_torch.core.dataset import LatencyDataset, fit_predictor_bank

        # Record counts guard freshness (arch count catches warm-store
        # profiling that adds an arch without new op measurements); the
        # store object itself is held in the entry and compared by
        # identity — an id()-keyed entry could alias a new store that
        # reused a dead one's address.
        counts = store.stats()
        ds_key = (counts["op_records"], counts["arch_records"],
                  setting_key(setting),
                  None if fingerprints is None else tuple(fingerprints))
        cached = self._ds_cache.get(ds_key)
        if cached is not None and cached[0] is store:
            ds = cached[1]
        else:
            archs = store.arch_records(setting, fingerprints=fingerprints)
            if not archs:
                raise ValueError(
                    f"store has no arch records for {setting_key(setting)} — "
                    f"profile graphs through a store-backed ProfileSession first")
            ds = LatencyDataset(setting_key(setting), archs)
            self._ds_cache.clear()          # keep only the latest assembly
            self._ds_cache[ds_key] = (store, ds)
        bank = fit_predictor_bank(ds, family, hparams=hparams,
                                  min_samples=min_samples, seed=seed,
                                  overhead_model=overhead_model,
                                  device=self.device)
        key = (setting_key(setting), family)
        self._install(key, bank)
        log.info("trained %s bank for %s on %d archs (%d op types)",
                 family, key[0], len(ds.archs), len(bank.predictors))
        if save and self.root:
            self.save_bank(setting, family)
        return bank

    def _install(self, key: Tuple[str, str], bank: PredictorBank) -> int:
        """Atomically publish ``bank`` under ``key``: bump version (so
        serving caches invalidate) and stamp the next epoch."""
        with self._lock:
            self.banks[key] = bank
            self.version += 1
            self.epoch += 1
            self.bank_epochs[key] = self.epoch
            return self.epoch

    def register(self, setting: DeviceSetting, family: str,
                 bank: PredictorBank, *, save: bool = False) -> PredictorBank:
        """Install an externally-built bank (e.g. a transfer-calibrated
        one) under ``(setting, family)``; bumps the version so service
        caches invalidate, and optionally persists it under ``root``."""
        key = (setting_key(setting), family)
        self._install(key, bank)
        log.info("registered %s bank for %s (%d op types)",
                 family, key[0], len(bank.predictors))
        if save and self.root:
            self._write_bank(key[0], family, bank)
        return bank

    def swap_bank(self, setting: Union[DeviceSetting, str], family: str,
                  bank: PredictorBank, *, save: bool = False) -> int:
        """Zero-downtime rollover: atomically replace the served bank
        for (setting, family) and return the new bank epoch.

        New predictions resolve the new bank immediately; flushes
        already in flight finish against the bank object they snapshot
        at admission (their reports keep the old epoch), so no request
        is lost or double-answered across the swap.  ``setting`` may be
        a `DeviceSetting` or a canonical setting-key string.
        """
        skey = setting if isinstance(setting, str) else setting_key(setting)
        key = (skey, family)
        epoch = self._install(key, bank)
        log.info("rolled over %s bank for %s -> epoch %d (%d op types)",
                 family, skey, epoch, len(bank.predictors))
        if save and self.root:
            self._write_bank(skey, family, bank)
        return epoch

    # -- lookup --------------------------------------------------------------
    def get(self, setting: DeviceSetting, family: str = "gbdt"
            ) -> Optional[PredictorBank]:
        """Bank for (setting, family): memory first, then ``root`` on disk."""
        key = (setting_key(setting), family)
        bank = self.banks.get(key)
        if bank is None and self.root:
            path = os.path.join(self.root, _bank_filename(*key))
            if os.path.exists(path):
                with open(path) as f:
                    bank = PredictorBank.from_json(json.load(f), self.device)
                self.banks[key] = bank
        return bank

    def get_with_epoch(self, setting: Union[DeviceSetting, str],
                       family: str = "gbdt"
                       ) -> Tuple[Optional[PredictorBank], int]:
        """(bank, its epoch) as one consistent snapshot — the pair a
        serving flush must hold onto across a concurrent `swap_bank`."""
        skey = setting if isinstance(setting, str) else setting_key(setting)
        key = (skey, family)
        with self._lock:
            bank = self.banks.get(key)
            if bank is not None:
                return bank, self.bank_epochs.get(key, 0)
        if isinstance(setting, str):
            return None, 0
        bank = self.get(setting, family)           # may load from disk
        with self._lock:
            return bank, self.bank_epochs.get(key, 0)

    def epoch_of(self, setting: Union[DeviceSetting, str],
                 family: str = "gbdt") -> int:
        skey = setting if isinstance(setting, str) else setting_key(setting)
        with self._lock:
            return self.bank_epochs.get((skey, family), 0)

    def epochs(self) -> Dict[str, Dict[str, int]]:
        """``{setting key: {family: epoch}}`` for every in-memory bank
        (epoch 0 = loaded from disk, never rolled over in this hub)."""
        with self._lock:
            out: Dict[str, Dict[str, int]] = {}
            for (skey, family) in self.banks:
                out.setdefault(skey, {})[family] = \
                    self.bank_epochs.get((skey, family), 0)
            return out

    # -- persistence ---------------------------------------------------------
    def _write_bank(self, key: str, family: str, bank: PredictorBank) -> str:
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, _bank_filename(key, family))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(bank.to_json(), f)
        os.replace(tmp, path)
        return path

    def save_bank(self, setting: DeviceSetting, family: str) -> str:
        if not self.root:
            raise ValueError("PredictorHub has no root directory")
        key = (setting_key(setting), family)
        return self._write_bank(key[0], family, self.banks[key])

    def save(self, root: Optional[str] = None) -> str:
        """Write every in-memory bank under ``root`` (defaults to self.root)."""
        if root:
            self.root = root
        if not self.root:
            raise ValueError("PredictorHub has no root directory")
        for (key, family), bank in self.banks.items():
            self._write_bank(key, family, bank)
        return self.root

    @classmethod
    def load(cls, root: str, device: DeviceLike = "cuda") -> "PredictorHub":
        """Restore every ``bank__*.json`` under ``root`` (lasso and MLP
        predictors on ``device``).

        Non-bank and malformed JSON files are skipped with a warning
        rather than raising: a hub directory may also hold sibling
        artifacts (transfer calibration maps, notes, reports).
        """
        hub = cls(root, device)
        if os.path.isdir(root):
            for fn in sorted(os.listdir(root)):
                if not (fn.startswith("bank__") and fn.endswith(".json")):
                    continue
                # Re-derive the key from the filename:
                # [device:]dtype__mode__family.
                stem = fn[len("bank__"):-len(".json")]
                parts = stem.split("__")
                if len(parts) < 3:
                    log.warning("skipping %s: not a bank filename", fn)
                    continue
                key, family = "/".join(parts[:-1]), parts[-1]
                path = os.path.join(root, fn)
                try:
                    with open(path) as f:
                        bank = PredictorBank.from_json(json.load(f), device)
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError, OSError) as e:
                    log.warning("skipping %s: not a loadable bank (%s)", fn, e)
                    continue
                hub.banks[(key, family)] = bank
        return hub

    def __len__(self) -> int:
        return len(self.banks)
