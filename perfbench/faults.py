"""Faults planted in the program under a run, to show that the check sees
them (tests/test_perfbench_faults.py on the CPU; ``calibrate.py --fault-seeds``
on the card, at the cell's own size).  Each ``plant(name)`` returns an
undo; a planted run must come out not correct.

In the training step: the optimizer's step does nothing (the state returned
unchanged: neither moments nor parameters move); the update skipped (Adam
at learning rate 0: its moments move, the parameters do not); the step
takes the first half of the batch (the mean over the rest); the step's
loss is altered by 1%.
"""

from __future__ import annotations

FAULTS = ('state unchanged', 'update skipped', 'half batch', 'answer altered')


def plant(fault: str):
    """Plant ``fault`` in the port's training step; returns a function that
    takes it out again."""
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    from waveflow_tpu_torch.vmc import trainer as trainer_mod
    make = trainer_mod.make_train_step

    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)
        if fault == 'state unchanged':
            step.optimizer.step = lambda *a, **k: None
            return step
        if fault == 'update skipped':
            for group in step.optimizer.param_groups:
                group['lr'] = 0.0
            return step
        if fault == 'half batch':
            def new(batch, baseline):
                return step(batch[:batch.shape[0] // 2], baseline)
        else:
            def new(batch, baseline):
                return step(batch, baseline) * 1.01
        new.optimizer = step.optimizer
        return new
    trainer_mod.make_train_step = wrapped
    return lambda: setattr(trainer_mod, 'make_train_step', make)
