"""p2pmicrogrid_tpu_torch — the PyTorch/CUDA port of p2pmicrogrid_tpu.

The port runs on an NVIDIA H100 and mirrors the JAX package's layout and
names. It imports torch and numpy only. Ported so far: shared-scenario
training (``parallel/scenarios.py``) of the tabular and DQN learners, with
the factored market, whose merged min pass is the hand-written CUDA kernel
``csrc/merged_min.cu``, with the multi-round matrix negotiation, whose split
and clearing passes are the CUDA kernels of ``csrc/matrix_market.cu``, and
with the fused slot, the whole slot as the one CUDA kernel
``csrc/slot_fused.cu``; and chunked aggregate-scenario training, its traces
made on the device and each chunk episode replayed as one CUDA graph
(``parallel/device_gen.py``, ``parallel/graph.py``); and serving
(``serve/``): policy bundles in the JAX package's format, a greedy engine
with one CUDA graph per padding bucket, its fronts and the HTTP gateway;
the recurrent LSTM models (``models/ddpg_recurrent.py``, its day-granular
trainer ``train/recurrent.py``, the forecaster ``models/forecast.py``),
served through a hidden-state ring; the scenario regime engine
(``regimes/``, ``ops/auction.py``) through the chunk graph; and the command
line, ``python -m p2pmicrogrid_tpu_torch`` (``cli.py``), over the results
store and telemetry warehouse of ``data/results.py``.
Entry points default to ``device="cuda"`` and raise without a card unless the
caller passes ``device="cpu"``.
"""
