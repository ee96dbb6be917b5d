"""Progressive learning: schedule, depth maps, growth and the AutoProg search."""
