"""The span ring of ``pocket_tts_tpu_torch`` for ``lfm2_flowlm_torch.py``: the
flagship system's readers (``pocket_tts_torch_spans.py``), which give None
where the program records no spans."""

from systems.pocket_tts_torch_spans import request_starts, spans  # noqa: F401
