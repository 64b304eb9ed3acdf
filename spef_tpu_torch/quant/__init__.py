"""Quantized (int8) executors of the converted QAT graph."""
