"""Pipelined prediction for the demo: counterpart of the JAX package's
demo/predictors.py (detectron2 demo/predictors.py's AsyncPredictor).

A host thread decodes and preprocesses frames ahead while the card runs
earlier ones: ``infer`` returns as soon as its launches are queued (CUDA
runs them asynchronously), and up to ``max_in_flight`` frames are queued
before the oldest is fetched.  Frames come out in input order.  ``cv2`` is
imported only to read video or a camera; without it the demo stops with a
message.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple


class AsyncPredictor:
    """``preprocess``: frame -> model input (host); ``infer``: model input
    -> device outputs (asynchronous launches); ``fetch``: device outputs ->
    host results (waits for the card)."""

    def __init__(self, preprocess: Callable, infer: Callable, fetch: Callable,
                 max_in_flight: int = 3, queue_size: int = 8):
        self.preprocess, self.infer, self.fetch = preprocess, infer, fetch
        self.max_in_flight, self.queue_size = max_in_flight, queue_size

    def __call__(self, frames: Iterable) -> Iterator[Tuple[object, object]]:
        """Yields (frame, host results) in input order."""
        pre_q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        end, failed = object(), []

        def producer():
            try:
                for frame in frames:
                    pre_q.put((frame, self.preprocess(frame)))
            except Exception as e:  # handed to the consumer, which raises it
                failed.append(e)
            finally:
                pre_q.put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        in_flight = []
        while True:
            item = pre_q.get()
            if item is end:
                break
            frame, inp = item
            in_flight.append((frame, self.infer(inp)))
            if len(in_flight) >= self.max_in_flight:
                f, dev = in_flight.pop(0)
                yield f, self.fetch(dev)
        for f, dev in in_flight:
            yield f, self.fetch(dev)
        t.join()
        if failed:
            raise failed[0]


def require_cv2():
    try:
        import cv2
    except ImportError:
        raise SystemExit("video and webcam input need OpenCV (cv2), which is not installed")
    return cv2


def webcam_frames(camera: int = 0, max_frames: Optional[int] = None):
    """RGB frames from a camera (``--input webcam``)."""
    cv2 = require_cv2()
    cap = cv2.VideoCapture(camera)
    if not cap.isOpened():
        raise SystemExit(f"cannot open camera {camera}")
    n = 0
    try:
        while max_frames is None or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[..., ::-1]  # BGR -> RGB
            n += 1
    finally:
        cap.release()


def video_frames(path: str):
    """RGB frames of a video file."""
    cv2 = require_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise SystemExit(f"cannot open video {path}")
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame[..., ::-1]
    finally:
        cap.release()
