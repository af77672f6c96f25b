from .decode import (  # noqa: F401
    BeamResult, RolloutResult, beam_search, greedy_search, tile_for_beams,
)
