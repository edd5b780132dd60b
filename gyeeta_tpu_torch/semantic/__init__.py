"""Semantic layer: the reference's self-learning health classification
(services, hosts, host cpu/memory) as tensor rule cascades over the
whole fleet's columns. Counterpart of ``gyeeta_tpu/semantic/``."""
