"""The comparison catches a broken timed path: the harness runs the cell
on the CPU with the program broken underneath, and `correct` comes out
false, once for each fault the cell can have (one card: no exchange
between cards to leave out)."""

import pytest
import torch

import helpers


def _emit_fault(monkeypatch, kind):
    def hook(driver):
        del driver
        from morphablegraphs_tpu_torch.ops import kernels
        inner = kernels.emit_frames

        def broken(*a, **kw):
            frames, last = inner(*a, **kw)
            if kind == "half":  # half of the batch left out
                frames[frames.shape[0] // 2:] = 0.0
            else:  # an answer altered where it is produced
                frames[..., 0] += 0.01
            return frames, last

        monkeypatch.setattr(kernels, "emit_frames", broken)
    return hook


def _state_fault(monkeypatch, cell):
    def hook(driver):
        if cell.endswith("crowd_root"):
            lm = driver.cw.lm

            def unchanged(fn, s0, n_iters, **kw):  # the LM's step
                return s0, torch.zeros(s0.shape[0], dtype=s0.dtype)

            monkeypatch.setattr(lm, "lm_minimize", unchanged)
        else:
            walk = driver.walk_mod

            def stay(g, node_id, type_id, gumbel):  # the walk's step
                return node_id, torch.ones_like(node_id, dtype=torch.bool)

            monkeypatch.setattr(walk, "choose_transition", stay)
    return hook


@pytest.mark.parametrize("cell", helpers.CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    hook = (_state_fault(monkeypatch, cell) if fault == "state_unchanged"
            else _emit_fault(monkeypatch, "half" if fault == "half_batch"
                             else "altered"))
    res = helpers.run_tiny(cell, 3000000023, hook=hook)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_control_is_not_correct_on_the_cpu(cell):
    """The control, the reference in the program's place with its matrix
    products' operands rounded to TF32, fails a limit; the program at the
    same size does not (the cuda test holds both at a larger size)."""
    torch.set_num_threads(2)
    tiny = {k: v for k, v in helpers.TINY[cell].items() if k != "traced_walks"}
    limits = helpers.tiny_spec(cell)["limits"]
    program = helpers.readings(cell, 3000000037, "cpu", tiny)
    control = helpers.readings(cell, 3000000037, "cpu", tiny, control=True)
    assert all(program[k] <= v for k, v in limits.items()), program
    assert any(control[k] > v for k, v in limits.items()), control


def test_lm_skipped_for_a_third_of_the_crowd_is_not_correct(monkeypatch):
    """The LM returns its start for a third of the characters and refines
    the rest: the median shortfall stays near 0, the share of stuck LM
    steps does not."""
    def hook(driver):
        lm = driver.cw.lm
        inner = lm.lm_minimize

        def partly(fn, s0, n_iters, **kw):
            s, err = inner(fn, s0, n_iters, **kw)
            k = s0.shape[0] // 3
            return torch.cat([s0[:k], s[k:]]), err

        monkeypatch.setattr(lm, "lm_minimize", partly)

    wide = dict(characters=12, steps=6, judged=12)
    sound = helpers.run_tiny("ref_walk.crowd_root", 3000000023,
                             traffic=wide)
    assert sound["correct"], sound["checks"]
    res = helpers.run_tiny("ref_walk.crowd_root", 3000000023, hook=hook,
                           traffic=wide)
    assert not res["correct"]
    assert res["checks"]["lm_stuck_share"]["value"] > \
        res["checks"]["lm_stuck_share"]["limit"], res["checks"]


def test_latents_not_seen_is_not_correct_and_named(monkeypatch):
    """A program whose step end no longer hands the driver the emitted
    latents: the run ends, `correct` is false, and latents_missing says
    why."""
    import contextlib

    def hook(driver):
        monkeypatch.setattr(driver, "_emitted",
                            lambda into: contextlib.nullcontext())

    res = helpers.run_tiny("ref_walk.crowd_root", 3000000023, hook=hook)
    assert not res["correct"]
    assert res["checks"]["latents_missing"]["value"] == 1
