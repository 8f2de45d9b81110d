"""Applications built on the port's public API — the JAX package's
``windflow_tpu/models``: DSPBench-style WordCount, SpikeDetection,
MarketTicker and FraudDetection, the flagship FFAT analytics pipeline,
its multi-GPU configuration ``mesh_analytics``, the
zero-per-tuple-Python telemetry pipeline over binary frames, and the
Yahoo-Streaming-Benchmark ad-analytics pipeline.  Each ``build()`` takes
a ``config`` and runs on ``config.device`` (the card by default)."""

from windflow_tpu_torch.models import (ad_analytics, ffat_analytics,
                                       fraud_detection, market_ticker,
                                       mesh_analytics, spike_detection,
                                       telemetry_frames, wordcount)
