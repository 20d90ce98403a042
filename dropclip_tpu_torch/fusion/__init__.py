"""Multi-view feature fusion."""
