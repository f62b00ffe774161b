"""The cells' drivers, one module a driver: a cell's traffic file names
its driver (`"driver": "ga"`), and portbench/run.py imports
`portbench.drivers.<driver>` by that name, so a new driver is a new file
here and needs no edit elsewhere.

A driver module has

    run(cell, seed, seconds, trace, device, control, t_start)
        -> (rec, checks, dev_info, attempted)

* cell: portbench.cell.Cell (its configuration, traffic and limits as
  read from their files); seed: the run's --seed, which alone decides the
  inputs; seconds: the timed window's length; trace: profile instead of
  timing (portbench/trace.py's `profile`); device: "cuda", or "cpu" in the
  CPU tests; control: run the cell's control in the program's place (a
  lower precision than the configuration states), which is the driver's
  own; t_start: the process's start on time.perf_counter, where setup_s
  begins.
* rec: harness.record(kind=..., setup_s=..., ...). Its kind is the
  driver's own ("ga", "adam", ...), and every reader tests rec.kind
  before it reads, so a reader returns None in another driver's cells. A
  timed run sets rec.window (units, seconds, blocks) and what its
  end-to-end readers read; a traced run sets rec.trace to profile's
  reading with "units" (the generations or steps traced) and what its
  per-layer readers read ("nodes_per_unit", "pair_px", ...). A block
  replayed as a CUDA graph gives profile its graph's span table
  (`span_table=lambda: run_block.graphs.last.spans`), so the reading's
  "spans" put the replayed operations down to the program's spans.
* checks: harness.check(name, value, limit) for each number compared with
  the plain reference (portbench/reference.py) once the window has closed
  and the program's state is freed; the run is correct when none is above
  its limit.
* dev_info: harness.device_info, read before the reference runs.
* attempted: the units of work the run attempted.

Faults for a driver's check (portbench/control.py --fault) sit in
portbench/faults.py's FAULTS under the driver's name or, for a driver
that brings its own, in a FAULTS dict of its module: fault name ->
function(pytest MonkeyPatch) that breaks the program underneath.
"""
