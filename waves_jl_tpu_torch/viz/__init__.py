"""Rendering and plots; matplotlib is imported only by the drawing
functions."""
from .episode import render_episode, rollout_fields
from .plot import (acoustic_plot_data, latent_source_period, make_plots_acoustic, make_plots_node,
                   make_plots_pinn, node_plot_data, pinn_plot_data, plot_energy, plot_field,
                   plot_latent_source, plot_predicted_energy, render_latent_solution,
                   render_line_video, render_video)
