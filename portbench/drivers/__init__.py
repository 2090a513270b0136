"""Traffic drivers: the code that a traffic mix's `driver` names. Each has
`make(config, seed, device)` -> a callable that runs one unit of work
(`unit(i)` -> its record: walls, counters, and the `answer` to judge) on
inputs made from the seed, `check(units, records)` -> the numbers compared
for each record's answer, and `control(units, records)` -> the same numbers
for the control (the reference, or the answers, in the precision below the
configuration's), and `describe(records)` -> the window's walls and counts
for the run's earlier lines. The callable may have `after_window()` -> the
records of units run after the window closed, judged with the window's, and
`close()`."""
