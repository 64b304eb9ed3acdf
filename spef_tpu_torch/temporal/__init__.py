"""Temporal (video) filtering and inference: the adaptive PDF filter, sequence
and streaming inference, the alternative filters and the report suite."""
