"""The JAX package's runnable examples, ported: each is a module run as
``python -m repro_torch.examples.<name>`` (on the card unless ``--device
cpu``), with ``run(..., device)`` returning its numbers as a dict and
``main(argv)`` printing them, nonzero when the example's own check fails.

* :mod:`.quickstart` — the paper's Algorithm 2: the matrix size fetched
  from process 0 with ``get`` and errors broadcast by CRCW resolution;
* :mod:`.fft_spectral` — the immortal FFT in use: low-pass filtering;
* :mod:`.pagerank_interop` — Algorithm 3: a host holding the shards
  hooks the unmodified PageRank;
* :mod:`.train_lm` — end-to-end training on a virtual (data, model) mesh,
  with checkpoints a restart resumes from.
"""
