"""Pose codecs: soft-classification encode/decode and the SPEUtils facade."""
