"""The int8 beam gate of ``chip_smoke.py`` (``envelope_gate``) on synthetic
n-best lists, on the CPU: a pure function of the lists, imported from the
script without a card.

The envelope is the plain twin un-noised and under seeded noises. Stable
utterances (every plain run gives the same 1-best at scores within the
tolerance) keep the fixed rule: the same 1-best at its score, or a swap of
the top two at their scores. Elsewhere the run's 1-best must be some plain
run's 1-best or 2-best at that run's score for those ids, or, where a plain
run's top two tie, any hypothesis at that run's 1-best score.
"""

import pytest

from chip_smoke import SCORE_ATOL, envelope_gate

ATOL = SCORE_ATOL["K6"]


def _h(ids, score):
    return ("", [], list(ids), float(score))


def _envelope():
    """Three utterances, the plain twin un-noised and under two noises: 0 is
    stable, 1 is unstable (a noise loses the eos and ends in a forced
    finish), 2 is stable with its top two near-tied."""
    un_noised = [[_h([1, 2], -10.0), _h([1, 3], -10.5)],
                 [_h([4], -248.364578), _h([4, 5], -251.0)],
                 [_h([1], -5.0), _h([2], -5.0002)]]
    noise_a = [[_h([1, 2], -10.001), _h([1, 3], -10.5)],
               [_h([4, 5, 6], -1.0e9), _h([4], -1.0e9 - 100.0)],
               [_h([1], -5.0001), _h([2], -5.0002)]]
    noise_b = [[_h([1, 2], -9.999), _h([1, 3], -10.5)],
               [_h([4], -248.36), _h([4, 5], -251.0)],
               [_h([1], -5.0), _h([2], -5.0001)]]
    return [un_noised, noise_a, noise_b]


def _run(u0=(_h([1, 2], -10.005), _h([1, 3], -10.5)),
         u1=(_h([4, 5, 6], -1.0e9 + 40.0), _h([4], -1.0e9)),
         u2=(_h([2], -5.0001), _h([1], -5.0))):
    return [list(u0), list(u1), list(u2)]


def test_a_run_inside_the_envelope_passes():
    """Scores within the tolerance on the stable utterance, the forced-finish
    flip on the unstable one (a noised run's 1-best at its score, 8 f32
    ulps of 1e9 being 512) and a near-tied swap on the third."""
    stable, bad = envelope_gate(_run(), _envelope(), ATOL)
    assert (stable, bad) == (2, [])
    stable, bad = envelope_gate(_run(u1=(_h([4], -248.37), _h([4, 5], -251.0))), _envelope(), ATOL)
    assert (stable, bad) == (2, [])


def test_a_shifted_score_on_a_stable_utterance_fails():
    _, bad = envelope_gate(_run(u0=(_h([1, 2], -11.0), _h([1, 3], -11.5))), _envelope(), ATOL)
    assert [u for u, _ in bad] == [0]


@pytest.mark.parametrize("u0", [
    (_h([7], -10.0), _h([1, 2], -10.0)),  # a 1-best no plain run has
    (_h([1, 3], -10.0), _h([1, 2], -10.5)),  # the plain 2-best first: its score 0.5 off, no near tie
])
def test_a_changed_1best_on_a_stable_utterance_fails_unless_a_near_tied_swap(u0):
    _, bad = envelope_gate(_run(u0=u0), _envelope(), ATOL)
    assert [u for u, _ in bad] == [0]


def test_a_tied_top_takes_any_1best_at_its_score():
    """Utterance 1 where a noised run ends in a forced finish whose top two
    tie (about -1e9, where an f32 ulp is 64): a 1-best that no plain run
    lists passes at that run's 1-best score, and fails 2048 below it; where
    no plain run's top is tied, unlisted ids fail at any score."""
    runs = _envelope()
    unlisted = _run(u1=(_h([4, 9], -1.0e9 - 64.0), _h([4, 7], -1.0e9 - 128.0)))
    assert envelope_gate(unlisted, runs, ATOL) == (2, [])
    below = _run(u1=(_h([4, 9], -1.0e9 - 2048.0), _h([4, 7], -1.0e9 - 2112.0)))
    assert [u for u, _ in envelope_gate(below, runs, ATOL)[1]] == [1]
    runs[1][1][1] = _h([4], -1.0e9 - 4096.0)  # the forced finish's top is no longer tied
    assert [u for u, _ in envelope_gate(unlisted, runs, ATOL)[1]] == [1]


def test_an_unstable_utterance_wants_some_plain_runs_1best_at_its_score():
    for u1 in ((_h([6], -248.36), _h([4], -248.36)),  # ids no plain run gave
               (_h([4], -250.0), _h([4, 5], -251.0))):  # the ids, at no plain run's score
        _, bad = envelope_gate(_run(u1=u1), _envelope(), ATOL)
        assert [u for u, _ in bad] == [1]
