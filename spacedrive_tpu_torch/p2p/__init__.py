"""Node identity (ed25519 keypairs); counterpart of the identity part of
`spacedrive_tpu/p2p/`."""
