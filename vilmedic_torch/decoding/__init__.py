from .decode import (  # noqa: F401
    BeamResult, RolloutResult, beam_search, constrained_greedy_search, greedy_and_sample,
    greedy_search, gumbel_noise, sample, stack_for_rollouts, tile_for_beams,
)
