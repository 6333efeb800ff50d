"""Parameters, encoder, decoder and model assembly."""
