"""RLHF pieces of PFIT (paper §IV-C): rollouts through the serving path,
the Bradley–Terry reward models and clipped PPO with GAE."""
