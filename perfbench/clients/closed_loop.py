"""A closed loop of one client: back-to-back calls, each on the next
batch of the pool in turn, each ending with its answer on the host. The
window ends when the call that crosses its length returns.

A traffic mix names it with ``"client": "closed_loop"`` and gives
``batch`` (queries a call), ``pool`` (queries drawn with the inputs) and
``k``.
"""
from __future__ import annotations

import time


def warm_up(sut, traffic: dict, call) -> None:
    """Each distinct batch once: the shapes the window will use."""
    for b in range(len(sut.batches)):
        call(b)


def window(sut, traffic: dict, seconds: float, call) -> dict:
    """Run the window: ``call(b)`` -> the answer to batch ``b``.

    Returns ``answers`` [(b, answer)], ``requests`` (queries answered),
    ``t0`` / ``t1`` (its start and the return of its last call) and
    ``per_second`` (queries answered in each whole second, a diagnostic)."""
    n = len(sut.batches)
    answers, ends = [], []
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        b = len(ends) % n
        answers.append((b, call(b)))
        ends.append(time.perf_counter())
        if ends[-1] >= end:
            break
    per_second = [0] * int(seconds)
    for (b, _), t in zip(answers, ends):
        if int(t - t0) < len(per_second):
            per_second[int(t - t0)] += sut.size(b)
    return {"answers": answers,
            "requests": sum(sut.size(b) for b, _ in answers),
            "t0": t0, "t1": ends[-1], "per_second": per_second}
