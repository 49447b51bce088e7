"""Canned policy scenarios run through the simulated probe
(reference: pkg/recipes/recipe.go, policies.go).

Each Recipe pairs one or more NetworkPolicy YAMLs (the well-known public
kubernetes-network-policy-recipes scenarios) with a Resources fixture and a
(protocol, port) to probe.
"""

from .recipes import ALL_RECIPES, Recipe, run_all_recipes

__all__ = ["ALL_RECIPES", "Recipe", "run_all_recipes"]
