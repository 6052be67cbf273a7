"""PyTorch/CUDA port of the QoS-aware LLM router (``repro``'s serving path).

The package mirrors ``repro``'s module names (``env/engine.py`` here ports
``repro/env/engine.py``, and so on) and imports only ``torch``, numpy and
the standard library.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (see ``repro_torch.device``).

The one hand-written kernel so far is ``kernels/lockstep_advance``: the
engine's admit/decode/idle loop in CUDA C++ (``csrc/lockstep_advance.cu``),
reached through ``env.engine.advance_all(backend="cuda")``.
"""
