"""repro_torch.dist — distribution substrate. Holds only the arena store's
byte codec (``compression.encode_bytes`` / ``decode_bytes``) so far."""
