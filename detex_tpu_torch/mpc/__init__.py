"""Visual-MPC engine: conv encoder, latent dynamics, MPPI, control step."""
