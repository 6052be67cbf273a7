"""The plain references, one file per family of configurations: a
configuration's file names its reference (``"reference"``), and the
check loads ``perfbench/references/<name>.py`` by that name.  Each holds
``Weights`` (the benchmark's weights by name, in float32 or, for the
control, fp8) and ``forward`` (the logits of judged positions over a
serving history), and imports nothing of the program."""
