"""The general generators of traffic, one a kind of mix: ``stream`` serves
windows of frames through ``serving.serve_stream``, ``train`` steps the
training loop."""
