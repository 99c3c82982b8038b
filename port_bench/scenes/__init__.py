"""Scene builders, one module a scene a configuration names: each makes
its raw arrays from the seed (`build`)."""
