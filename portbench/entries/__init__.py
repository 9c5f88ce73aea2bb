"""How the benchmark drives one kind of request: one module per ``entry``
that a traffic mix names, found by that name.

An entry module holds ``Entry(config, traffic, seed, device, fault=None)``.
Its constructor is the set-up: the inputs and weights from the seed, the
program's task, and a warm-up of every shape the mix uses (which, under CUDA
graphs, captures them). Then:

* ``kind``: ``serve`` (the harness times each ``request(i)``, one in
  flight) or ``train`` (the harness runs ``request(i)`` back to back and
  ends the window in a synchronisation);
* ``request(i)``: the i-th request or step, through the program's own
  entry; ``keep(i, out)`` (serving) keeps what it answered;
* ``host_sample()`` (training): one step's host time on an idle card;
* ``release()``: drop the program's state;
* ``sample()``: the requests whose outputs are judged, drawn from the seed;
* ``numbers(outputs)``: the judged numbers (``judge``) of ``outputs``, by
  default what the program served; ``reference_outputs(round)``: what the
  plain reference computing through ``round`` serves instead (the control).

``fault`` breaks the timed path on purpose (the limits' readings and the
tests): ``half_batch`` steps on the first half of every batch;
``stale_batch`` (training) feeds the three followed replays the warm-up's
last batch, as a replay whose input copies were left out would read it.
"""
