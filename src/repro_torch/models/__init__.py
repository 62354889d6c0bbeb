"""Model code of the port: configs, blocks and the decoder's paged path."""
