"""PyTorch/CUDA port of the QoS-aware LLM router (``repro``'s two serving
paths: the routing loop and the LM experts).

The package mirrors ``repro``'s module names (``env/engine.py`` here ports
``repro/env/engine.py``, and so on) and imports only ``torch``, numpy and
the standard library.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (see ``repro_torch.device``).

The hand-written kernels so far, CUDA C++ under ``csrc/``:
``kernels/lockstep_advance``, the engine's admit/decode/idle loop
(``csrc/lockstep_advance.cu``), reached through
``env.engine.advance_all(backend="cuda")``; and ``kernels/flash_attn``,
prefill attention (``csrc/flash_attn.cu``), reached through
``models.transformer.attention_full``.
"""
