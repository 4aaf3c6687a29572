"""The LIBSVM `phishing` dataset (`byzantinemomentum_tpu/data/svm.py`).

68 dense features parsed from the LIBSVM sparse text format, labels in
{0, 1} as float32 `(N, 1)`, split at 8400 into train and test. Reads
`phishing`, `phishing.txt` or `phishing.libsvm` from the data dirs
(`data/sources.py`; nothing is downloaded), else generates the JAX
package's deterministic synthetic problem with the same shapes, bit for
bit. The dataset is of kind "raw": no image transform.
"""

import os

import numpy as np

from byzantinemomentum_tpu_torch import data as _data
from byzantinemomentum_tpu_torch import utils
from byzantinemomentum_tpu_torch.data import sources

__all__ = ["load_phishing"]

FEATURES = 68
SPLIT = 8400
TOTAL = 11055  # rows of the published LIBSVM phishing dataset


def _parse_libsvm(path):
    text = path.read_text().strip().split("\n")
    inputs = np.zeros((len(text), FEATURES), np.float32)
    labels = np.empty((len(text), 1), np.float32)
    for index, entry in enumerate(text):
        parts = entry.split()
        labels[index, 0] = 1.0 if parts[0] == "1" else 0.0
        for setter in parts[1:]:
            offset, value = setter.split(":")
            inputs[index, int(offset) - 1] = float(value)
    return inputs, labels


def _synthetic_phishing():
    """`(inputs, labels, split)`: $BMT_SYNTH_TRAIN train rows (at most the
    real 8400) and $BMT_SYNTH_TEST test rows (the real remainder by
    default)."""
    train = min(int(os.environ.get("BMT_SYNTH_TRAIN", SPLIT)), SPLIT)
    test = int(os.environ.get("BMT_SYNTH_TEST", TOTAL - SPLIT))
    total = train + test
    rng = np.random.default_rng(0x5F15)
    w = rng.normal(size=(FEATURES,)).astype(np.float32)
    inputs = rng.random((total, FEATURES), dtype=np.float32)
    logits = (inputs - 0.5) @ w + rng.normal(0, 0.5, total).astype(np.float32)
    labels = (logits > 0).astype(np.float32)[:, None]
    return inputs, labels, train


def load_phishing(**unused):
    path = sources._find("phishing", "phishing.txt", "phishing.libsvm")
    if path is not None:
        inputs, labels = _parse_libsvm(path)
        split = min(SPLIT, len(inputs) - 1)
    else:
        utils.trace("phishing: raw file not found on disk; using the "
                    "deterministic synthetic fallback")
        inputs, labels, split = _synthetic_phishing()
    return {"train_x": inputs[:split], "train_y": labels[:split],
            "test_x": inputs[split:], "test_y": labels[split:],
            "kind": "raw", "synthetic": path is None}


_data.register("phishing", load_phishing)
