"""Vertical-FL datasets: NUS-WIDE and Lending Club (port of
``fedml_tpu/data/vertical.py``, numpy only: the same files give the same
arrays).

``VerticalDataset`` is the contract VFLAPI consumes: party-major feature
arrays over the SAME samples (party 0 = guest holds the labels), plus a
test split."""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class VerticalDataset:
    name: str
    train_xs: List[np.ndarray]  # per party [n, d_k], shared sample axis
    train_y: np.ndarray  # [n] binary
    test_xs: List[np.ndarray]
    test_y: np.ndarray

    @property
    def feature_splits(self):
        return [x.shape[1] for x in self.train_xs]


def zscore(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """StandardScaler equivalent (ref normalize(), lending_club_dataset.py)."""
    x = np.asarray(x, np.float32)
    return (x - x.mean(0)) / (x.std(0) + eps)


# --------------------------------------------------------------------------
# NUS-WIDE (ref nus_wide_dataset.py): party A = 634 low-level image
# features, party B = 1k text tags; labels = top-k concept one-hots reduced
# to "is target concept". On-disk layout mirrored from the reference:
#   Groundtruth/TrainTestLabels/Labels_<concept>_<Train|Test>.txt
#   Low_Level_Features/<Train|Test>_Normalized_<kind>.dat  (space-sep)
#   NUS_WID_Tags/<Train|Test>_Tags1k.dat                   (tab-sep)
# --------------------------------------------------------------------------


def _read_matrix(path: str, sep: Optional[str]) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            vals = line.split(sep) if sep else line.split()
            vals = [v for v in vals if v.strip() != ""]
            if vals:
                rows.append([float(v) for v in vals])
    return np.asarray(rows, np.float32)


def _nus_split(data_dir: str, labels: Sequence[str], dtype: str):
    lab_dir = os.path.join(data_dir, "Groundtruth", "TrainTestLabels")
    cols = [
        _read_matrix(os.path.join(lab_dir, f"Labels_{l}_{dtype}.txt"), None)[:, 0]
        for l in labels
    ]
    onehot = np.stack(cols, axis=1)
    # samples carrying exactly one selected concept (ref sum(axis=1)==1)
    keep = onehot.sum(1) == 1 if len(labels) > 1 else np.ones(len(onehot), bool)

    feat_dir = os.path.join(data_dir, "Low_Level_Features")
    feats = [
        _read_matrix(os.path.join(feat_dir, f), None)
        for f in sorted(os.listdir(feat_dir))
        if f.startswith(f"{dtype}_Normalized")
    ]
    xa = np.concatenate(feats, axis=1)[keep]
    tags_path = os.path.join(data_dir, "NUS_WID_Tags", f"{dtype}_Tags1k.dat")
    xb = _read_matrix(tags_path, "\t")[keep]
    y = onehot[keep].argmax(1).astype(np.int32)
    return xa, xb, y


def load_nus_wide(
    data_dir: str,
    selected_labels: Sequence[str] = ("buildings", "grass", "animal", "water", "person"),
    target_label_idx: int = 0,
    parties: int = 2,
    max_samples: int = -1,
) -> VerticalDataset:
    """2-party (image features | tags) or 3-party (tags halved — ref
    get_labeled_data_with_3_party) vertical dataset; y = 1 iff the sample's
    concept == selected_labels[target_label_idx]."""
    out = []
    for dtype in ("Train", "Test"):
        xa, xb, y = _nus_split(data_dir, selected_labels, dtype)
        if max_samples != -1:
            xa, xb, y = xa[:max_samples], xb[:max_samples], y[:max_samples]
        yy = (y == target_label_idx).astype(np.float32)
        if parties == 2:
            xs = [xa, xb]
        elif parties == 3:
            h = xb.shape[1] // 2
            xs = [xa, xb[:, :h], xb[:, h:]]
        else:
            raise ValueError("parties must be 2 or 3")
        out.append((xs, yy))
    (train_xs, train_y), (test_xs, test_y) = out
    return VerticalDataset("nus_wide", train_xs, train_y, test_xs, test_y)


# --------------------------------------------------------------------------
# Lending Club (ref lending_club_dataset.py + lending_club_feature_group.py):
# one CSV of loan records; the VFL parties are the reference's FEATURE
# GROUPS — qualification features vs loan/debt/repayment features — and the
# binary target is good/bad loan.
# --------------------------------------------------------------------------

# Column groups from the reference's feature-group module (subset kept to
# numeric columns; categorical maps below mirror lending_club_dataset.py).
QUALIFICATION_FEATURES = [
    "annual_inc", "emp_length", "home_ownership", "verification_status", "grade",
]
LOAN_FEATURES = [
    "loan_amnt", "int_rate", "installment", "term", "purpose", "dti",
]
REPAYMENT_FEATURES = [
    "total_pymnt", "total_rec_int", "total_rec_prncp", "last_pymnt_amnt",
]

GRADE_MAP = {"A": 6, "B": 5, "C": 4, "D": 3, "E": 2, "F": 1, "G": 0}
EMP_LENGTH_MAP = {
    "": 0, "< 1 year": 1, "1 year": 2, "2 years": 2, "3 years": 2,
    "4 years": 3, "5 years": 3, "6 years": 3, "7 years": 4, "8 years": 4,
    "9 years": 4, "10+ years": 5,
}
HOME_OWNERSHIP_MAP = {"RENT": 0, "MORTGAGE": 1, "OWN": 2, "ANY": 3, "NONE": 3, "OTHER": 3}
VERIFICATION_MAP = {"Not Verified": 0, "Source Verified": 1, "Verified": 2}
TERM_MAP = {" 36 months": 0, "36 months": 0, " 60 months": 1, "60 months": 1}
PURPOSE_MAP = {
    "debt_consolidation": 0, "credit_card": 0, "small_business": 1,
    "educational": 2, "car": 3, "other": 3, "vacation": 3, "house": 3,
    "home_improvement": 3, "major_purchase": 3, "medical": 3,
    "renewable_energy": 3, "moving": 3, "wedding": 3,
}
BAD_LOAN_STATUSES = {
    "Charged Off", "Default",
    "Does not meet the credit policy. Status:Charged Off",
    "In Grace Period", "Late (16-30 days)", "Late (31-120 days)",
}
_CATEGORICAL = {
    "grade": GRADE_MAP,
    "emp_length": EMP_LENGTH_MAP,
    "home_ownership": HOME_OWNERSHIP_MAP,
    "verification_status": VERIFICATION_MAP,
    "term": TERM_MAP,
    "purpose": PURPOSE_MAP,
}


def _encode(col: str, val: str) -> float:
    table = _CATEGORICAL.get(col)
    if table is not None:
        return float(table.get(val, 0))
    try:
        return float(val)
    except ValueError:
        return 0.0


def load_lending_club(
    csv_path: str,
    max_rows: Optional[int] = None,
    test_frac: float = 0.2,
    seed: int = 0,
) -> VerticalDataset:
    """CSV → 3-party vertical dataset: guest holds qualification features +
    the good/bad-loan label; hosts hold loan-terms and repayment features
    (ref target_map + loan_condition, lending_club_dataset.py)."""
    groups = [QUALIFICATION_FEATURES, LOAN_FEATURES, REPAYMENT_FEATURES]
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        rows = []
        for i, r in enumerate(reader):
            if max_rows is not None and i >= max_rows:
                break
            rows.append(r)
    if not rows:
        raise ValueError(f"{csv_path}: empty CSV")
    present = [[c for c in g if c in rows[0]] for g in groups]
    if any(not g for g in present):
        raise ValueError(
            f"{csv_path}: each party needs at least one of its columns; "
            f"have {sorted(rows[0])}"
        )
    xs = [
        zscore(np.asarray([[_encode(c, r[c]) for c in g] for r in rows], np.float32))
        for g in present
    ]
    y = np.asarray(
        [1.0 if r.get("loan_status", "") in BAD_LOAN_STATUSES else 0.0 for r in rows],
        np.float32,
    )
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    n_test = max(1, int(round(test_frac * len(y))))
    te, tr = perm[:n_test], perm[n_test:]
    return VerticalDataset(
        "lending_club",
        [x[tr] for x in xs],
        y[tr],
        [x[te] for x in xs],
        y[te],
    )


def run_vfl(dataset: VerticalDataset, epochs: int = 10, lr: float = 0.05, batch_size: int = 64,
            hidden_dim: int = 16, seed: int = 0, device=None):
    """Train VFLAPI on a VerticalDataset; returns (api, final_stats)."""
    from fedml_tpu_torch.algorithms.vertical_fl import VFLAPI

    api = VFLAPI(
        feature_splits=dataset.feature_splits,
        hidden_dim=hidden_dim,
        lr=lr,
        seed=seed,
        device=device,
    )
    stats = {}
    for _ in range(epochs):
        stats = api.train_epoch(dataset.train_xs, dataset.train_y, batch_size=batch_size)
    return api, stats
