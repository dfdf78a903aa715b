"""Job kinds of the benchmark, one module each, named by a traffic file's
`"job"`. A module offers `setup(config, traffic, seed, device)`, which
makes the inputs from the seed, stages the port and returns a job. A kind
that serves cells of several cards also takes the keyword `devices`: the
harness calls it for a cell of `chips` n > 1 as `setup(config, traffic,
seed, device=devices[0], devices=devices)`, with the cell's cards
cuda:0 to cuda:n-1 in order (in the CPU tests, as many CPU devices), and
for a cell of one card as before, without the keyword. The job has:

- `work`: each rate metric's units in one job; `sample`: how many answers
  the harness keeps (a seeded sample), None for all; `trace_jobs`: the
  jobs the traced stretch holds;
- `warm_up()`; `run(i)`: job i of the window, returned once the device
  has finished it; `keep(i, answer)`: what the check needs of an answer;
  `spans(answer)`: the program's own timings of a job;
- `counters()`: the port's launch counters; `facts()`: what per-layer
  readers need of the staged program (read before `free()`);
- `free()`: drops the program's state; `check(kept)`: the numbers that
  decide `correct`, from the reference;

and a module-level `control(job)`: the same numbers with the reference,
computed one precision lower, in the program's place.
"""
