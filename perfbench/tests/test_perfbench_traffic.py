"""The seeded traffic generator: reproducible, in range, the same work for
every seed."""

import json
import math
import os
from collections import Counter

import pytest

from tiny import REPO

from harness import traffic

SPEAKERS = ["ryan", "aiden", "serena", "vivian", "uncle_fu", "dylan", "eric",
            "ono_anna", "sohee"]


def _mix(name):
    with open(os.path.join(REPO, "perfbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["batch64", "chat64"])
def test_same_seed_same_requests(name):
    mix = _mix(name)
    assert traffic.generate(mix, SPEAKERS, 2**31 + 17) == \
        traffic.generate(mix, SPEAKERS, 2**31 + 17)
    assert traffic.generate(mix, SPEAKERS, 2**31 + 17) != \
        traffic.generate(mix, SPEAKERS, 2**31 + 18)


@pytest.mark.parametrize("name", ["batch64", "chat64"])
def test_requests_keep_to_the_mix(name):
    mix = _mix(name)
    lo, hi = mix["frames"]
    clients = traffic.generate(mix, SPEAKERS, 5_000_000_000)
    assert len(clients) == mix["clients"]
    for reqs in clients:
        assert len(reqs) == mix["rounds"]
        for r, req in enumerate(reqs):
            first = mix["first_frames_min"]
            low = first if (r == 0 and first is not None) else lo
            assert low <= req["frames"] <= hi
            assert len(req["text"]) <= mix["max_chars"]
            assert req["text"].endswith(".") and "." not in req["text"][:-1]
            assert req["voice"] in SPEAKERS
            assert req["instruct"] is None or req["instruct"] in mix["instructs"]
            # one segment: the daemon splits text at 600 characters
            assert len(req["text"]) <= 600
    for r in range(mix["rounds"]):
        with_instruct = sum(c[r]["instruct"] is not None for c in clients)
        assert with_instruct == round(mix["instruct_share"] * mix["clients"])


@pytest.mark.parametrize("name", ["batch64", "chat64"])
def test_every_seed_gets_the_same_work(name):
    mix = _mix(name)

    def work(seed):
        clients = traffic.generate(mix, SPEAKERS, seed)
        return [(Counter(c[r]["frames"] for c in clients),
                 Counter(c[r]["voice"] for c in clients),
                 sorted(len(c[r]["text"]) for c in clients))
                for r in range(mix["rounds"])]

    assert work(1) == work(2**31 + 99) == work(2**40 + 3)


def test_budgets_are_log_uniform_quantiles():
    mix = _mix("batch64")
    lo, hi = mix["frames"]
    budgets = sorted(c[1]["frames"] for c in traffic.generate(mix, SPEAKERS, 3))
    n = len(budgets)
    want = [round(math.exp(math.log(lo) + (i + 0.5) / n * math.log(hi / lo)))
            for i in range(n)]
    assert budgets == want


def test_chat_first_requests_are_staggered():
    mix = _mix("chat64")
    clients = traffic.generate(mix, SPEAKERS, 11)
    firsts = [c[0]["frames"] for c in clients]
    assert min(firsts) == mix["first_frames_min"]
    assert len(set(firsts)) > len(firsts) // 2
