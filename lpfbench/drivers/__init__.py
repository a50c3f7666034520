"""One driver per kind of work a traffic mix drives (``"driver"`` in the
mix's file): ``run(cell, seed=, seconds=, trace=, device=, clock_zero=)``
gives the run's :class:`~lpfbench.harness.Outcome`, and ``control(cell,
seed, device, kind)`` the numbers the judgement compares with something
else in the program's place."""
