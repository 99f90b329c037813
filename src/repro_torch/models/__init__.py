"""Model zoo (port of ``repro.models``): the attention decoder, forward only."""
