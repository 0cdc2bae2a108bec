"""``correct`` has to come out false for the control (the reference one
precision below in the program's place) and for each fault a cell can
have, driven through the rest of a run at a test size on the CPU."""

import pytest
import torch

from portbench import control, harness
from portbench.tests import tiny

SERVING = ["r50-int8-offline-b256", "yolov1-dyn8-offline-b64"]


@pytest.mark.parametrize("name", SERVING)
def test_int4_control_is_not_correct(name):
    run = tiny.run(name)
    run.hooks.update(control.control_hooks(run))
    harness.execute(run)
    assert not harness.is_correct(run), run.checks


def test_bf16_training_control_is_not_correct():
    run = tiny.run("r50-train-bf16-b64")
    numbers = control.control_run(run)
    assert any(v > run.limit(k) for k, v in numbers.items()), numbers


def _altered(predict):
    """One answer altered where it is produced: the first image's best
    candidate gets another class."""

    def wrapped(images):
        d = predict(images)
        class_ids = d.class_ids.clone()
        class_ids[0, int(torch.argmax(d.scores[0]))] += 1
        return d._replace(class_ids=class_ids)

    return wrapped


def _shifted_box(predict):
    def wrapped(images):
        d = predict(images)
        boxes = d.boxes.clone()
        boxes[0, 0, 0] += 0.05
        return d._replace(boxes=boxes)

    return wrapped


@pytest.mark.parametrize("fault", [_altered, _shifted_box])
@pytest.mark.parametrize("name", SERVING)
def test_an_altered_answer_is_not_correct(name, fault):
    run = tiny.execute(name, hooks={"wrap_predict": fault})
    assert not harness.is_correct(run), run.checks


def _unchanged(step):
    """A step that returns its state unchanged: a loss, no update."""

    def wrapped(images, targets):
        return {"total": torch.zeros(())}

    return wrapped


@pytest.mark.parametrize("fault", [_unchanged, control.half_batch])
def test_training_faults_are_not_correct(fault):
    run = tiny.execute("r50-train-bf16-b64", hooks={"wrap_step": fault})
    assert not harness.is_correct(run), run.checks


def test_sound_runs_of_every_cell_are_correct_on_two_seeds():
    for name in SERVING + ["r50-train-bf16-b64"]:
        for seed in (5, 2 ** 33 + 1):
            run = tiny.execute(name, seed=seed, seconds=0.2)
            assert harness.is_correct(run), (name, seed, run.checks)
