"""Control words (plans) and the control plane that computes them."""
