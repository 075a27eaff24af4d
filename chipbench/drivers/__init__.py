"""Drivers: one a family of configurations, named by the ``driver`` key of
a configuration file.  A driver module gives

  * ``setup(ctx) -> system``: the program built from the cell's inputs,
    its shapes warmed;
  * ``serve(system, ctx) -> record.RunRecord``: the load started, the
    window measured, every request due in it answered (or given up a
    minute past the close);
  * ``release(system)``: the program's state freed;
  * ``check(system, record, ctx) -> dict``: {number: value}, the
    program's outputs held against ``chipbench.reference``, each number
    beside its limit in the configuration's ``limits``;
  * ``control(ctx) -> dict``: the same numbers with the reference one
    precision step down in the program's place (``chipbench.control``),
    from the same inputs ``setup`` makes.
"""
