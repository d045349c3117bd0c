"""The training stream's decode window, on the CPU.

``train/data.py::image_folder_batches`` keeps at most ``2 * workers *
batch_size`` files submitted and not yet taken:

* with ``_load_crop`` wrapped to count its calls and a consumer that
  sleeps, no more than the window's files are decoded ahead of it;
* closing the generator after two batches of a 2,000-file folder of
  10 ms loads cancels the queued loads and returns in well under a second
  (an executor that held the whole epoch decoded all of it first);
* the stream still equals JAX's ``image_folder_batches`` element for
  element over two epochs, with a window smaller than the folder.
"""

import threading
import time

import numpy as np
import pytest
from PIL import Image

from imagecompression_adversarial_tpu.train import data as j_data
from imagecompression_adversarial_tpu_torch.train import data


def _folder(root, n, size=24, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        sub = root / ("a" if i % 2 else "b")
        sub.mkdir(exist_ok=True)
        h, w = size + int(rng.integers(0, 9)), size + int(rng.integers(0, 9))
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(sub / f"{i:04d}.png")


@pytest.mark.parametrize("workers,batch_size", [(2, 2), (3, 4)])
def test_no_more_than_the_window_is_decoded_ahead(tmp_path, monkeypatch, workers, batch_size):
    _folder(tmp_path, 60)
    calls = []
    lock = threading.Lock()
    load = data._load_crop

    def counted(*args):
        with lock:
            calls.append(1)
        return load(*args)

    monkeypatch.setattr(data, "_load_crop", counted)
    window = 2 * workers * batch_size
    stream = data.image_folder_batches(str(tmp_path), batch_size, crop=16, seed=3,
                                       workers=workers, epochs=1)
    taken = 0
    for _ in range(5):
        next(stream)
        taken += batch_size
        time.sleep(0.05)  # a slow consumer: the decoders run ahead meanwhile
        with lock:
            ahead = len(calls) - taken
        assert 0 <= ahead <= window
    stream.close()
    assert len(calls) <= taken + window < 60


def test_closing_cancels_the_queued_decodes(tmp_path, monkeypatch):
    for i in range(2000):
        (tmp_path / f"{i:04d}.png").touch()
    crop = np.zeros((4, 4, 3), np.float32)
    calls = []

    def slow(path, size, rng):
        calls.append(path)
        time.sleep(0.01)
        return crop, None

    monkeypatch.setattr(data, "_load_crop", slow)
    stream = data.image_folder_batches(str(tmp_path), 8, crop=4, workers=8, epochs=1)
    next(stream), next(stream)
    t0 = time.perf_counter()
    stream.close()
    assert time.perf_counter() - t0 < 1.0
    assert len(calls) <= 16 + 2 * 8 * 8


def test_the_windowed_stream_equals_jax_over_two_epochs(tmp_path):
    _folder(tmp_path, 41, seed=5)
    # window 2 * 2 * 3 = 12 files, about a quarter of the folder
    kw = dict(crop=20, seed=7, workers=2, epochs=2)
    ours = list(data.image_folder_batches(str(tmp_path), 3, **kw))
    theirs = list(j_data.image_folder_batches(str(tmp_path), 3, **kw))
    assert len(ours) == len(theirs) == 26  # 13 batches of 3 an epoch, drop-last
    for got, want in zip(ours, theirs):
        np.testing.assert_array_equal(got, want)
