"""Host-side data: media writers and the synthetic AV dataset."""
