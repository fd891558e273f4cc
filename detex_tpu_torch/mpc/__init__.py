"""Visual-MPC engine: conv encoder, latent dynamics, MPPI, iLQR, the
control step and the dynamics training loop."""
